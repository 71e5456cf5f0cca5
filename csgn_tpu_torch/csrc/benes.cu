// K8 / K9 / K12: Beneš delta-swap permutation of packed chunks, optionally
// fused with the decrypt count of the permuted output.
//
// Replaces csgn_tpu/ops/permute_benes.py:apply_benes_pallas (K8, one plan),
// apply_benes_batch_pallas (K9, plan i on batch element i: plan_stride =
// S*WP) and apply_benes_decrypt_pallas (K12, `kCount`).
//
//   out bit i of every chunk = in bit perm[i]
//   stage s, delta < 32:  t = (x ^ (x << d)) & m[r];  x ^= t ^ (t >> d)
//   stage s, delta >= 32: rows r and r + R (R = delta/32, bit R of r clear)
//                         exchange the bits of m[r]:
//                         x[r] = (x[r] & ~m[r]) | (x[r+R] & m[r]), and back
//   count (kCount)      = #{chunks : (out & key) == key on every word}
//
// The pairwise form of the cross-word stage is the roll form of the plain
// version (permute_benes.py `_delta_swap`) because a plan's mask rows are
// zero wherever bit R of the row is set (`_route` marks only positions with
// (i & delta) == 0), so the partner row r + R never wraps.
//
// Bound on the H100: integer operations.  Each chunk is read and written
// once (W words each way), but its network costs, a three-input LOP3
// counting one, 4 integer operations per nonzero in-word mask word (two
// shifts, two LOP3) and 2 per nonzero cross-word pair (one bit-select LOP3 a
// word) of the live rows: 2,022 a chunk on a random plan at n = 1247, 1.27
// times its bytes' time.
// One thread owns one chunk column for the whole network; threads never read
// each other's columns, so the stages need no barrier.  Two paths, chosen by
// the network's width WP = n_pad / 32 (ops/benes_kernels.py `benes_path`):
//
//   * register path, WP <= 64 (n <= 2048): the column is `uint32_t col[WP]`,
//     templated on WP, with every row index a compile-time constant, so it
//     lives in registers.  The stage loop runs at run time and reads each
//     stage's delta and live rows from the schedule.  An in-word stage runs
//     the rows unrolled with a run-time shift; a cross-word stage switches to
//     one unrolled block per R, which exchanges bits between register pairs.
//     A live window is a multiple of 8 rows (or all WP), so it is tested once
//     per 8 rows, uniformly; zero mask words are computed rather than
//     branched around (on a random plan at n = 1247, 389 of the 400 live
//     in-word words are nonzero).  Masks are read as 16-byte broadcasts from
//     shared memory, one per 4 rows;
//   * shared path, WP > 64 (up to MAX_WORDS_PAD = 512 in the wrapper): the
//     column does not fit in registers and lives in shared memory as
//     tile[row][thread] (row-major with stride blockDim.x, so a warp's
//     accesses to one row hit 32 distinct banks).  Each live row costs a
//     shared load and store; zero mask words skip their row with a branch
//     that never diverges.
//
// Common to both paths:
//   * rows [w_net, WP) start as zeros (the network's padding); output rows
//     [w_net, W) are stored as zeros (n < 32, where W = 2 > WP = 1);
//   * the schedule (delta, live rows; rows 0 = stage off in every plan) and
//     the plan's masks [S, WP] are staged in shared memory once per block;
//   * batch element b comes from blockIdx.y (the host launches one grid per
//     65535 elements) and selects plan masks + b * plan_stride;
//   * the count is a per-thread eq-all over the output column (the register
//     path ORs the key bits its column misses, one LOP3 a row), a warp sum
//     and one 64-bit atomicAdd per warp that found a match (exact in any
//     order), into count[b];
//   * all offsets are 64-bit ([k, W, C] with k*C = 2^24 passes 2^31 words);
//     the ragged last column block is bounds-checked, not padded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // chunk columns per block (at most)
constexpr int kMaxRegisterWords = 64;   // widest network of the register path
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int64_t kMaxGridY = 65535;

// Shared memory of both paths after the shared path's tile: masks
// [stages][wp], key [max(w, wp)] (count only; zero past w, so the register
// path reads it in quads like the masks), schedule [stages][2].
struct Staged {
  uint32_t* masks;
  uint32_t* key;
  int32_t* sched;
};

__host__ __device__ __forceinline__ int64_t key_words(int64_t w, int64_t wp, bool count) {
  return count ? (w > wp ? w : wp) : 0;
}

__device__ __forceinline__ Staged stage_operands(uint32_t* base, const uint32_t* masks,
                                                 const int32_t* sched, const uint32_t* key,
                                                 int wp, int stages, int64_t w, bool count) {
  Staged st;
  st.masks = base;
  st.key = base + stages * wp;
  const int64_t kw = key_words(w, wp, count);
  st.sched = reinterpret_cast<int32_t*>(st.key + kw);
  const int bc = blockDim.x;
  for (int i = threadIdx.x; i < stages * wp; i += bc) st.masks[i] = masks[i];
  for (int i = threadIdx.x; i < 2 * stages; i += bc) st.sched[i] = sched[i];
  for (int64_t r = threadIdx.x; r < kw; r += bc) st.key[r] = r < w ? key[r] : 0u;
  __syncthreads();
  return st;
}

__device__ __forceinline__ void add_matches(unsigned long long* count, bool match) {
  const unsigned n = __reduce_add_sync(0xffffffffu, match ? 1u : 0u);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(count, static_cast<unsigned long long>(n));
}

// ---------------------------------------------------------------------------
// Register path
// ---------------------------------------------------------------------------

// Mask words [r, r + N) of one stage; N = 4 is one 16-byte broadcast load.
template <int N>
__device__ __forceinline__ void load_masks(uint32_t (&mk)[N], const uint32_t* m) {
  if constexpr (N == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(m);
    mk[0] = q.x;
    mk[1] = q.y;
    mk[2] = q.z;
    mk[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) mk[i] = m[i];
  }
}

// Rows go in groups of G = min(WP, 8), the live window's granularity, and
// masks in quads of Q = min(WP, 4) rows.
template <int WP>
__device__ __forceinline__ void in_word(uint32_t (&col)[WP], const uint32_t* m, int d, int rows) {
  constexpr int G = WP < 8 ? WP : 8;
  constexpr int Q = WP < 4 ? WP : 4;
#pragma unroll
  for (int g = 0; g < WP; g += G) {
    if (g < rows) {
#pragma unroll
      for (int q = g; q < g + G; q += Q) {
        uint32_t mk[Q];
        load_masks<Q>(mk, m + q);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const uint32_t v = col[q + i];
          const uint32_t t = (v ^ (v << d)) & mk[i];
          col[q + i] = v ^ t ^ (t >> d);  // uint32_t: a logical shift
        }
      }
    }
  }
}

template <int WP, int R>
__device__ __forceinline__ void cross_word(uint32_t (&col)[WP], const uint32_t* m, int rows) {
  if constexpr (R < WP) {
    constexpr int G = WP < 8 ? WP : 8;
    constexpr int Q = WP < 4 ? WP : 4;
#pragma unroll
    for (int g = 0; g < WP; g += G) {
      if (g < rows) {
#pragma unroll
        for (int q = g; q < g + G; q += Q) {
          if (R < Q || (q & R) == 0) {  // the quad holds a lower row of a pair
            uint32_t mk[Q];
            load_masks<Q>(mk, m + q);
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              if (((q + i) & R) == 0) {
                constexpr int kMask = WP - 1;  // keeps dead branches' indices in range
                const int lo = q + i, hi = (q + i + R) & kMask;
                const uint32_t a = col[lo], b = col[hi], sel = mk[i];
                col[lo] = (a & ~sel) | (b & sel);  // a bit select: one LOP3 a word
                col[hi] = (b & ~sel) | (a & sel);
              }
            }
          }
        }
      }
    }
  }
}

template <int WP, bool kCount>
__global__ void __launch_bounds__(kThreads)
benes_register_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ masks,
                      const int32_t* __restrict__ sched, const uint32_t* __restrict__ key,
                      uint32_t* __restrict__ out, unsigned long long* __restrict__ count,
                      int64_t w, int64_t c, int stages, int w_net, int64_t plan_stride) {
  const int64_t b = blockIdx.y;
  extern __shared__ uint4 smem_reg[];  // 16-byte aligned for the mask quads
  const Staged st = stage_operands(reinterpret_cast<uint32_t*>(smem_reg), masks + b * plan_stride,
                                   sched, key, WP, stages, w, kCount);

  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = j < c;  // inactive lanes run on zeros for the warp sum
  const uint32_t* src = x + b * w * c + j;
  uint32_t col[WP];
#pragma unroll
  for (int r = 0; r < WP; ++r) col[r] = (active && r < w_net) ? src[r * c] : 0u;

  for (int s = 0; s < stages; ++s) {
    const int delta = st.sched[2 * s];
    const int rows = st.sched[2 * s + 1];
    const uint32_t* m = st.masks + s * WP;
    switch (delta) {  // the wrapper admits only these deltas (`network_deltas`)
      case 32: cross_word<WP, 1>(col, m, rows); break;
      case 64: cross_word<WP, 2>(col, m, rows); break;
      case 128: cross_word<WP, 4>(col, m, rows); break;
      case 256: cross_word<WP, 8>(col, m, rows); break;
      case 512: cross_word<WP, 16>(col, m, rows); break;
      case 1024: cross_word<WP, 32>(col, m, rows); break;
      default: in_word<WP>(col, m, delta, rows); break;
    }
  }

  if (active) {
    uint32_t* dst = out + b * w * c + j;
#pragma unroll
    for (int r = 0; r < WP; ++r) {
      if (r < w_net) dst[r * c] = col[r];
    }
    for (int64_t r = w_net; r < w; ++r) dst[r * c] = 0u;
  }
  if constexpr (kCount) {
    // A chunk matches when its output misses no key bit.  Key rows past w
    // are staged as zeros, and output rows [WP, w) (n < 32) are zero.
    constexpr int Q = WP < 4 ? WP : 4;
    uint32_t miss = 0;
#pragma unroll
    for (int q = 0; q < WP; q += Q) {
      uint32_t k[Q];
      load_masks<Q>(k, st.key + q);
#pragma unroll
      for (int i = 0; i < Q; ++i) miss |= k[i] & ~col[q + i];
    }
    for (int64_t r = WP; r < w; ++r) miss |= st.key[r];
    add_matches(count + b, active && miss == 0u);
  }
}

// ---------------------------------------------------------------------------
// Shared path
// ---------------------------------------------------------------------------

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
benes_shared_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ masks,
                    const int32_t* __restrict__ sched, const uint32_t* __restrict__ key,
                    uint32_t* __restrict__ out, unsigned long long* __restrict__ count,
                    int64_t w, int64_t c, int wp, int stages, int w_net, int64_t plan_stride) {
  const int64_t b = blockIdx.y;
  extern __shared__ uint32_t smem[];
  const int bc = blockDim.x;
  uint32_t* tile = smem;  // [wp][bc]
  const Staged st = stage_operands(tile + static_cast<size_t>(wp) * bc, masks + b * plan_stride,
                                   sched, key, wp, stages, w, kCount);

  const int64_t col = static_cast<int64_t>(blockIdx.x) * bc + threadIdx.x;
  const bool active = col < c;  // inactive lanes stay for the warp sum
  uint32_t* my = tile + threadIdx.x;
  bool ok = true;
  if (active) {
    const uint32_t* src = x + b * w * c + col;
    for (int r = 0; r < w_net; ++r) my[r * bc] = src[r * c];
    for (int r = w_net; r < wp; ++r) my[r * bc] = 0u;

    for (int s = 0; s < stages; ++s) {
      const int delta = st.sched[2 * s];
      const int rows = st.sched[2 * s + 1];
      const uint32_t* m = st.masks + s * wp;
      if (delta < 32) {
        for (int r = 0; r < rows; ++r) {
          const uint32_t mr = m[r];
          if (!mr) continue;
          const uint32_t v = my[r * bc];
          const uint32_t t = (v ^ (v << delta)) & mr;
          my[r * bc] = v ^ t ^ (t >> delta);  // uint32_t: a logical shift
        }
      } else {
        const int rr = delta >> 5;
        for (int base = 0; base < rows; base += 2 * rr) {
          const int top = min(base + rr, rows);
          for (int r = base; r < top; ++r) {
            const uint32_t mr = m[r];
            if (!mr) continue;
            const uint32_t lo = my[r * bc], hi = my[(r + rr) * bc];
            const uint32_t t = (lo ^ hi) & mr;
            my[r * bc] = lo ^ t;
            my[(r + rr) * bc] = hi ^ t;
          }
        }
      }
    }

    uint32_t* dst = out + b * w * c + col;
    for (int r = 0; r < w_net; ++r) dst[r * c] = my[r * bc];
    for (int64_t r = w_net; r < w; ++r) dst[r * c] = 0u;
    if (kCount) {
      for (int64_t r = 0; r < w; ++r) {
        const uint32_t k = st.key[r];
        if (!k) continue;  // uniform across the block
        const uint32_t v = r < w_net ? my[r * bc] : 0u;
        ok &= (v & k) == k;
      }
    }
  }
  if (kCount) add_matches(count + b, active && ok);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const uint32_t* x;
  const uint32_t* masks;
  const int32_t* sched;
  const uint32_t* key;
  uint32_t* out;
  unsigned long long* count;
  int64_t batch, w, c, wp, stages, w_net, plan_stride;
  cudaStream_t stream;
};

// Launches kernel(e0 slice args...) once per 65535 batch elements; the
// slice's (b, plan, count) come in through offset base pointers, so b
// restarts at 0 in every slice.
template <typename Kernel, typename... Tail>
cudaError_t launch_slices(Kernel kernel, const Args& a, int64_t bc, size_t smem, Tail... tail) {
  const int64_t blocks = (a.c + bc - 1) / bc;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  for (int64_t e0 = 0; e0 < a.batch; e0 += kMaxGridY) {
    const int64_t n = a.batch - e0 < kMaxGridY ? a.batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    kernel<<<grid, static_cast<unsigned>(bc), smem, a.stream>>>(
        a.x + e0 * a.w * a.c, a.masks + e0 * a.plan_stride, a.sched, a.key,
        a.out + e0 * a.w * a.c, a.count + (a.count ? e0 : 0), a.w, a.c, tail...,
        static_cast<int>(a.stages), static_cast<int>(a.w_net), a.plan_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

size_t operand_bytes(const Args& a, bool count) {
  return static_cast<size_t>(a.stages * a.wp + key_words(a.w, a.wp, count) + 2 * a.stages) *
         sizeof(uint32_t);
}

template <int WP, bool kCount>
cudaError_t launch_register(const Args& a) {
  const size_t smem = operand_bytes(a, kCount);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  return launch_slices(benes_register_kernel<WP, kCount>, a, kThreads, smem);
}

template <bool kCount>
cudaError_t launch_register_wp(const Args& a) {
  switch (a.wp) {
    case 1: return launch_register<1, kCount>(a);
    case 2: return launch_register<2, kCount>(a);
    case 4: return launch_register<4, kCount>(a);
    case 8: return launch_register<8, kCount>(a);
    case 16: return launch_register<16, kCount>(a);
    case 32: return launch_register<32, kCount>(a);
    case kMaxRegisterWords: return launch_register<kMaxRegisterWords, kCount>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kCount>
cudaError_t launch_shared(const Args& a) {
  auto smem_for = [&](int64_t bc) {
    return static_cast<size_t>(a.wp * bc) * sizeof(uint32_t) + operand_bytes(a, kCount);
  };
  int64_t bc = kThreads;
  while (bc > 32 && smem_for(bc) > kSmemLimit) bc /= 2;
  const size_t smem = smem_for(bc);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  return launch_slices(benes_shared_kernel<kCount>, a, bc, smem, static_cast<int>(a.wp));
}

}  // namespace

// x [batch, w, c] -> out [batch, w, c]; masks [*, stages, wp] with element b
// using masks + b * plan_stride (0: one plan for all); sched int32
// [stages, 2] of (delta, live rows).  With `key` [w] non-null, also adds
// element b's match count into the zeroed int64 count[b].  path 0 is the
// register path (wp a power of two <= 64), 1 the shared path.  Launches
// ceil(batch / 65535) grids.  Returns cudaGetLastError().
extern "C" int csgn_benes(const void* x, const void* masks, const void* sched, const void* key,
                          void* out, void* count, int64_t batch, int64_t w, int64_t c,
                          int64_t wp, int64_t stages, int64_t w_net, int64_t plan_stride,
                          int64_t path, void* stream) {
  if (w_net > wp || w_net > w) return cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(masks),
               static_cast<const int32_t*>(sched), static_cast<const uint32_t*>(key),
               static_cast<uint32_t*>(out), static_cast<unsigned long long*>(count),
               batch, w, c, wp, stages, w_net, plan_stride, static_cast<cudaStream_t>(stream)};
  const bool counted = key != nullptr;
  if (path == 0) return counted ? launch_register_wp<true>(a) : launch_register_wp<false>(a);
  if (path == 1) return counted ? launch_shared<true>(a) : launch_shared<false>(a);
  return cudaErrorInvalidValue;
}
