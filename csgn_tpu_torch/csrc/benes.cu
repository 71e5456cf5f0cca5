// K8 / K9 / K12: Beneš delta-swap permutation of packed chunks, optionally
// fused with the decrypt count of the permuted output.
//
// Replaces csgn_tpu/ops/permute_benes.py:apply_benes_pallas (K8, one plan),
// apply_benes_batch_pallas (K9, plan i on batch element i: plan_stride =
// S*WP; on the register path also on k tensors and k plans wherever they
// are stored, through a table of their base pointers, `kTable`) and
// apply_benes_decrypt_pallas (K12, `kCount`).
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
// Three paths, chosen by the network's width WP = n_pad / 32
// (ops/benes_kernels.py `benes_path`):
//
//   * register path, WP <= 64 (n <= 2048): one thread owns one chunk column
//     for the whole network, `uint32_t col[WP]`, templated on WP, with every
//     row index a compile-time constant, so it lives in registers and the
//     stages need no barrier.  The stage loop runs at run time and reads
//     each stage's delta and live rows from the schedule.  An in-word stage
//     runs the rows unrolled with a run-time shift; a cross-word stage
//     switches to one unrolled block per R, which exchanges bits between
//     register pairs (benes_network.cuh).  A live window is a multiple of 8
//     rows (or all WP), so it is tested once per 8 rows, uniformly; zero
//     mask words are computed rather than branched around (on a random plan
//     at n = 1247, 389 of the 400 live in-word words are nonzero).  Masks
//     are read as 16-byte broadcasts from shared memory, one per 4 rows.
//     The network alone holds the ALU pipe (at 2^24 chunks on an H100 the
//     copy alone took 1.84 ms, the network alone 2.92 and the kernel with
//     128-thread blocks 3.49: PERF.md), so the design takes ALU issue off
//     it: the in-word stage puts its shifts on the FMA pipe
//     (`in_word_fma`), a row's address is the last one's plus c (r * c
//     computed anew took about nine instructions a row), and blocks of 256
//     threads, three an SM (80 registers a thread, no spills), stage the
//     plan half as often a column as blocks of 128 and hide more latency
//     than five blocks of 128 did.  The column's loads go out before the
//     plan is staged.  A
//     persistent grid (the SMs' resident blocks walking the tiles, the next
//     column's rows prefetched in registers or by cp.async) was slower than
//     this grid in every form tried (PERF.md);
//   * lane-group path, 64 < WP <= 2048 (n <= 65536; benes_lanes.cu): the
//     column split over the registers of a group of lanes of one warp;
//   * wide path, WP > 2048 (n > 65536; see its section below): a block's
//     threads split each stage's rows over a tile of up to 32 chunk
//     columns, four columns a thread, with a barrier between stages; the
//     masks are read from global memory (L1/L2) instead of staged, and the
//     tile is in shared memory or, past WP = 32768, in a global scratch.
//
// Common to all paths:
//   * rows [w_net, WP) start as zeros (the network's padding); output rows
//     [w_net, W) are stored as zeros (n < 32, where W = 2 > WP = 1);
//   * the schedule (delta, live rows; rows 0 = stage off in every plan) and
//     the plan's masks [S, WP] are staged in shared memory once per block
//     (register path; the lane-group path up to WP = 1024);
//   * batch element b comes from blockIdx.y (the host launches one grid per
//     65535 elements) and selects plan masks + b * plan_stride;
//   * the count is an eq-all over the output column (the register path ORs
//     the key bits its column misses, one LOP3 a row), a warp sum and one
//     64-bit atomicAdd per warp that found a match (exact in any order),
//     into count[b] (the wide path: see its section);
//   * all offsets are 64-bit ([k, W, C] with k*C = 2^24 passes 2^31 words);
//     the ragged last column block is bounds-checked, not padded.

#include "benes_network.cuh"

namespace benes {
namespace {

constexpr int kThreads = 256;           // chunk columns per block of the register path
constexpr int kRegisterBlocks = 3;      // its blocks an SM: 80 registers a thread
constexpr int kMaxRegisterWords = 64;   // widest network of the register path
constexpr size_t kSmemPerTwoBlocks = 112 * 1024;  // two blocks on an SM's 228 KB
constexpr int kWideThreads = 768;       // the wide path's block: two fit an SM

// The register path's shared memory: masks [stages][wp] (an in-word stage's
// shifted right by its delta), key [max(w, wp)] (count only; zero past w, so
// it is read in quads like the masks), schedule [stages][2].
struct Staged {
  uint32_t* masks;
  uint32_t* key;
  int32_t* sched;
};

__device__ __forceinline__ Staged stage_operands(uint32_t* base, const uint32_t* masks,
                                                 const int32_t* sched, const uint32_t* key,
                                                 int wp, int stages, int64_t w, bool count) {
  Staged st;
  st.masks = base;
  st.key = base + stages * wp;
  const int64_t kw = key_words(w, wp, count);
  st.sched = reinterpret_cast<int32_t*>(st.key + kw);
  const int bc = blockDim.x;
  for (int i = threadIdx.x; i < stages * wp; i += bc) {
    const int d = __ldg(sched + 2 * (i / wp));
    st.masks[i] = d < 32 ? masks[i] >> d : masks[i];  // `in_word_fma`'s m >> d
  }
  for (int i = threadIdx.x; i < 2 * stages; i += bc) st.sched[i] = sched[i];
  for (int64_t r = threadIdx.x; r < kw; r += bc) st.key[r] = r < w ? key[r] : 0u;
  __syncthreads();
  return st;
}

// ---------------------------------------------------------------------------
// Register path (the stage arithmetic is benes_network.cuh's)
// ---------------------------------------------------------------------------

// An in-word stage with half its work on the FMA pipe.  On the H100 the
// shifts and LOP3s of `in_word` share the ALU pipe, and IMAD issues on the
// FMA pipe.  A plan's in-word masks mark only the upper bit of a pair (b & d
// != 0; `_route` marks positions i with (i & d) == 0, MSB first), so with
// m' = m >> d staged, t' = (v ^ (v >> d)) & m' is t >> d, and t ^ (t >> d)
// = t' * (1 + 2^d) (disjoint bits); v >> d = umulhi(v, 2^(32 - d)).  Two
// LOP3s and two IMADs a word instead of two LOP3s and two shifts.
template <int N>
__device__ __forceinline__ void in_word_fma(uint32_t (&col)[N], const uint32_t* m, int d,
                                            int rows) {
  constexpr int G = N < 8 ? N : 8;
  constexpr int Q = N < 4 ? N : 4;
  const uint32_t hi = 1u << (32 - d);
  const uint32_t both = 1u + (1u << d);
#pragma unroll
  for (int g = 0; g < N; g += G) {
    if (g < rows) {
#pragma unroll
      for (int q = g; q < g + G; q += Q) {
        uint32_t mk[Q];
        load_masks<Q>(mk, m + q);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const uint32_t v = col[q + i];
          const uint32_t t = (v ^ __umulhi(v, hi)) & mk[i];
          col[q + i] = v ^ (t * both);
        }
      }
    }
  }
}

// kTable (K9 on requests and plans where they are stored): x and masks are
// entries of a device table of pointers (`Source`), element b's words [w, c]
// at x[b], read through the read-only path, and its plan's masks at
// masks[b]; the output stays one [batch, w, c] tensor.  Without it x is the
// batch's words [batch, w, c] and masks its plans, plan_stride words apart.
template <int WP, bool kCount, bool kTable>
__global__ void __launch_bounds__(kThreads, kRegisterBlocks)
benes_register_kernel(Source<kTable> __restrict__ x, Source<kTable> __restrict__ masks,
                      const int32_t* __restrict__ sched, const uint32_t* __restrict__ key,
                      uint32_t* __restrict__ out, unsigned long long* __restrict__ count,
                      int64_t w, int64_t c, int stages, int w_net, int64_t plan_stride) {
  const int64_t b = blockIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = j < c;  // inactive lanes run on zeros for the warp sum
  // The column's loads go out before the plan is staged, so the two wait
  // together; a row's address is the last one's plus c.
  const uint32_t* src;
  if constexpr (kTable) {
    src = x[b] + j;
  } else {
    src = x + b * w * c + j;
  }
  uint32_t col[WP];
  {
    const uint32_t* p = src;
#pragma unroll
    for (int r = 0; r < WP; ++r, p += c) {
      if constexpr (kTable) {
        col[r] = (active && r < w_net) ? __ldg(p) : 0u;
      } else {
        col[r] = (active && r < w_net) ? *p : 0u;
      }
    }
  }

  extern __shared__ uint4 smem_reg[];  // 16-byte aligned for the mask quads
  const uint32_t* plan;
  if constexpr (kTable) {
    plan = masks[b];
  } else {
    plan = masks + b * plan_stride;
  }
  const Staged st = stage_operands(reinterpret_cast<uint32_t*>(smem_reg), plan, sched, key, WP,
                                   stages, w, kCount);
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
      default: in_word_fma<WP>(col, m, delta, rows); break;
    }
  }

  if (active) {
    uint32_t* dst = out + b * w * c + j;
    {
      uint32_t* p = dst;
#pragma unroll
      for (int r = 0; r < WP; ++r, p += c) {
        if (r < w_net) *p = col[r];
      }
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
// Wide path
// ---------------------------------------------------------------------------
//
// Any WP, routed past the lane-group path (WP > 2048, n > 65536), where not
// even a lane group holds a column in registers and the plan (at least 0.5
// MB) fits no SM; a tile of 32 columns at one column a thread would leave
// one warp on an SM.
// Here a block of kWideThreads (768) threads shares a tile of cb chunk
// columns: each thread works on V adjacent columns (V = 4 where cb >= 4, one
// 16-byte shared access, one mask load and one address for four words; else
// 1) of one row slot, and the slots split the live rows (or cross-word
// pairs) of every stage, with a block barrier between stages.  The tile is
// row-major, tile[r][k], so a quarter warp's accesses are 128 contiguous
// bytes: the coalesced load and store of x and out, and the stages, are free
// of bank conflicts (but for a 2-way conflict on the pairs of R < 4).  The
// plan's masks, the schedule and the key are read from global memory through
// the read-only path; a mask word serves all cb chunks of the block, so each
// block reads the plan once.  The launch bound keeps two blocks on an SM (42
// registers, no spills; 1024-thread blocks spilled at 32).  The row loops
// are not unrolled (unrolled by 2 they ran 1 % slower), and a zero mask word
// is computed (a no-op), not branched around.
//
//   * kTile: the tile is in shared memory; cb is the largest power of two
//     up to 32 whose WP x cb words leave room for two blocks on an SM (16 at
//     WP = 1024, 4 at 4096, 1 at 16384), else for one (1 at 32768);
//   * otherwise (WP > 32768, n > 2^20) each block's tile of 32 columns is a
//     region of a global scratch (the wrapper allocates it), the stages the
//     same with global loads and stores.
//
// The count ORs each chunk's missed key bits into a shared word per chunk,
// then adds one per matching chunk.

// V consecutive words of a tile row (16-byte aligned for V = 4).
template <int V>
__device__ __forceinline__ void tile_load(uint32_t (&v)[V], const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void tile_store(uint32_t* p, const uint32_t (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <bool kCount, bool kTile, int V>
__global__ void __launch_bounds__(kWideThreads, 2)  // two blocks an SM: 42 registers
benes_wide_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ masks,
                  const int32_t* __restrict__ sched, const uint32_t* __restrict__ key,
                  uint32_t* __restrict__ out, unsigned long long* __restrict__ count,
                  uint32_t* __restrict__ scratch, int64_t w, int64_t c, int log_cb, int wp,
                  int stages, int w_net, int64_t plan_stride) {
  constexpr int kLogV = V == 4 ? 2 : (V == 2 ? 1 : 0);
  const int64_t b = blockIdx.y;
  const int cb = 1 << log_cb;
  const int log_lanes = log_cb - kLogV;  // threads per tile row
  const int k = (threadIdx.x & ((1 << log_lanes) - 1)) << kLogV;  // the first column
  const int slot = threadIdx.x >> log_lanes;
  const int slots = blockDim.x >> log_lanes;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * cb + k;  // idle columns run on zeros
  const uint32_t* xb = x + b * w * c;
  uint32_t* ob = out + b * w * c;
  const uint32_t* mb = masks + b * plan_stride;
  extern __shared__ uint4 wide_smem[];  // 16-byte aligned rows
  __shared__ uint32_t miss[32];
  uint32_t* tile = kTile ? reinterpret_cast<uint32_t*>(wide_smem)
                         : scratch + (b * gridDim.x + blockIdx.x) * (static_cast<int64_t>(wp)
                                                                     << log_cb);

  if (kCount && threadIdx.x < cb) miss[threadIdx.x] = 0u;
  for (int r = slot; r < wp; r += slots) {
    uint32_t v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (j + i < c && r < w_net) ? xb[r * c + j + i] : 0u;
    tile_store<V>(tile + (r << log_cb) + k, v);
  }
  __syncthreads();

  for (int s = 0; s < stages; ++s) {
    const int delta = __ldg(sched + 2 * s);
    const int rows = __ldg(sched + 2 * s + 1);
    const uint32_t* m = mb + static_cast<int64_t>(s) * wp;
    if (delta < 32) {
#pragma unroll 1
      for (int r = slot; r < rows; r += slots) {
        const uint32_t mr = __ldg(m + r);
        uint32_t* at = tile + (r << log_cb) + k;
        uint32_t v[V];
        tile_load<V>(v, at);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const uint32_t t = (v[i] ^ (v[i] << delta)) & mr;
          v[i] ^= t ^ (t >> delta);  // uint32_t: a logical shift
        }
        tile_store<V>(at, v);
      }
    } else {
      // Pair p of the stage is row r = p with a zero bit R inserted, and its
      // partner r + R (< WP, since bit R of r is clear); rows [0, rows) hold
      // `pairs` lower rows.
      const int rr = delta >> 5;
      const int pairs = rows / (2 * rr) * rr + min(rows % (2 * rr), rr);
#pragma unroll 1
      for (int p = slot; p < pairs; p += slots) {
        const int r = p + (p & ~(rr - 1));
        const uint32_t mr = __ldg(m + r);
        uint32_t* lo_at = tile + (r << log_cb) + k;
        uint32_t* hi_at = lo_at + (rr << log_cb);
        uint32_t lo[V], hi[V];
        tile_load<V>(lo, lo_at);
        tile_load<V>(hi, hi_at);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const uint32_t l = lo[i];
          lo[i] = (l & ~mr) | (hi[i] & mr);  // a bit select: one LOP3 a word
          hi[i] = (hi[i] & ~mr) | (l & mr);
        }
        tile_store<V>(lo_at, lo);
        tile_store<V>(hi_at, hi);
      }
    }
    __syncthreads();
  }

  if constexpr (kCount) {
    uint32_t missed[V] = {};
    for (int64_t r = slot; r < w; r += slots) {
      const uint32_t kr = __ldg(key + r);
      uint32_t v[V] = {};
      if (r < w_net) tile_load<V>(v, tile + (r << log_cb) + k);
#pragma unroll
      for (int i = 0; i < V; ++i) missed[i] |= kr & ~v[i];
    }
    // OR across the warp's threads on the same columns first, so that each
    // miss word takes one shared atomic per warp.
#pragma unroll
    for (int i = 0; i < V; ++i) {
      for (int off = 1 << log_lanes; off < 32; off <<= 1) {
        missed[i] |= __shfl_xor_sync(0xffffffffu, missed[i], off);
      }
      if ((threadIdx.x & 31) < (1 << log_lanes) && missed[i]) atomicOr(&miss[k + i], missed[i]);
    }
    __syncthreads();
    if (threadIdx.x < cb && static_cast<int64_t>(blockIdx.x) * cb + threadIdx.x < c &&
        miss[threadIdx.x] == 0u) {
      atomicAdd(count + b, 1ull);
    }
  }
  for (int64_t r = slot; r < w; r += slots) {
    uint32_t v[V] = {};
    if (r < w_net) tile_load<V>(v, tile + (r << log_cb) + k);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (j + i < c) ob[r * c + j + i] = v[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

size_t operand_bytes(const Args& a, bool count) {
  return static_cast<size_t>(a.stages * a.wp + key_words(a.w, a.wp, count) + 2 * a.stages) *
         sizeof(uint32_t);
}

template <int WP, bool kCount, bool kTable>
cudaError_t launch_register(const Args& a) {
  const size_t smem = operand_bytes(a, kCount);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  return launch_slices<kTable>(benes_register_kernel<WP, kCount, kTable>, a, kThreads, kThreads,
                               smem);
}

template <bool kCount, bool kTable = false>
cudaError_t launch_register_wp(const Args& a) {
  switch (a.wp) {
    case 1: return launch_register<1, kCount, kTable>(a);
    case 2: return launch_register<2, kCount, kTable>(a);
    case 4: return launch_register<4, kCount, kTable>(a);
    case 8: return launch_register<8, kCount, kTable>(a);
    case 16: return launch_register<16, kCount, kTable>(a);
    case 32: return launch_register<32, kCount, kTable>(a);
    case kMaxRegisterWords: return launch_register<kMaxRegisterWords, kCount, kTable>(a);
    default: return cudaErrorInvalidValue;
  }
}

// Chunks per block of the wide path's tile in shared memory: the most (a
// power of two up to 32) that leave room for two blocks on an SM, else for
// one (0: not even one column fits, so the tile goes to the global scratch,
// kWideGlobalChunks a block).  At WP = 1024 and one column a thread, 16
// columns in two blocks ran 1.3x faster than 32 in one block on an H100
// (PERF.md, the wide path's findings).
int wide_tile_chunks(int64_t wp) {
  int cb = 32;
  while (cb > 1 && static_cast<size_t>(cb * wp) * sizeof(uint32_t) > kSmemPerTwoBlocks) cb /= 2;
  while (cb > 0 && static_cast<size_t>(cb * wp) * sizeof(uint32_t) > kSmemLimit) cb /= 2;
  return cb;
}

constexpr int kWideGlobalChunks = 32;

template <bool kCount, bool kTile, int V>
cudaError_t launch_wide_mode(const Args& a, uint32_t* scratch, int cb) {
  const int log_cb = __builtin_ctz(cb);
  const size_t smem = kTile ? static_cast<size_t>(cb * a.wp) * sizeof(uint32_t) : 0;
  auto kernel = benes_wide_kernel<kCount, kTile, V>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (a.c + cb - 1) / cb;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  for (int64_t e0 = 0; e0 < a.batch; e0 += kMaxGridY) {
    const int64_t n = a.batch - e0 < kMaxGridY ? a.batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    kernel<<<grid, kWideThreads, smem, a.stream>>>(
        a.x + e0 * a.w * a.c, a.masks + e0 * a.plan_stride, a.sched, a.key,
        a.out + e0 * a.w * a.c, a.count + (a.count ? e0 : 0),
        kTile ? nullptr : scratch + e0 * blocks * cb * a.wp, a.w, a.c, log_cb,
        static_cast<int>(a.wp), static_cast<int>(a.stages), static_cast<int>(a.w_net),
        a.plan_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// path 2 takes the tile while one fits; path 3 forces the global scratch,
// which must then hold batch * ceil(c / 32) * 32 * wp words.
template <bool kCount>
cudaError_t launch_wide(const Args& a, uint32_t* scratch, bool force_global) {
  const int cb = wide_tile_chunks(a.wp);
  if (cb >= 4 && !force_global) return launch_wide_mode<kCount, true, 4>(a, nullptr, cb);
  if (cb > 0 && !force_global) return launch_wide_mode<kCount, true, 1>(a, nullptr, cb);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch_wide_mode<kCount, false, 4>(a, scratch, kWideGlobalChunks);
}

}  // namespace
}  // namespace benes

// x [batch, w, c] -> out [batch, w, c]; masks [*, stages, wp] with element b
// using masks + b * plan_stride (0: one plan for all); sched int32
// [stages, 2] of (delta, live rows).  With `key` [w] non-null, also adds
// element b's match count into the zeroed int64 count[b].  path 0 is the
// register path (wp a power of two <= 64), 1 the lane-group path (wp in
// 128..2048, w <= wp, masks in the lane layout), 4 its ring form (wp = 128,
// c % 4 == 0, x and out 16-byte aligned), 2 the wide path (its tile,
// or the global scratch where no tile fits), 3 the wide path on its global
// scratch.  `scratch` (paths 2 and 3 without a tile) holds batch * ceil(c /
// 32) * 32 * wp words.  path 5 is the register path's table form, without
// the count: x is then a device table of 2 * batch pointers, element b's
// words [w, c] at x[b] and its plan's masks [stages, wp] at x[batch + b]
// (masks and plan_stride unused).  Launches ceil(batch / 65535) grids.
// Returns cudaGetLastError().
extern "C" int csgn_benes(const void* x, const void* masks, const void* sched, const void* key,
                          void* out, void* count, void* scratch, int64_t batch, int64_t w,
                          int64_t c, int64_t wp, int64_t stages, int64_t w_net,
                          int64_t plan_stride, int64_t path, void* stream) {
  using namespace benes;
  if (w_net > wp || w_net > w) return cudaErrorInvalidValue;
  const bool table = path == 5;
  const Args a{table ? nullptr : static_cast<const uint32_t*>(x),
               static_cast<const uint32_t*>(masks),
               static_cast<const int32_t*>(sched), static_cast<const uint32_t*>(key),
               static_cast<uint32_t*>(out), static_cast<unsigned long long*>(count),
               batch, w, c, wp, stages, w_net, plan_stride, static_cast<cudaStream_t>(stream),
               table ? static_cast<const uint32_t* const*>(x) : nullptr};
  const bool counted = key != nullptr;
  uint32_t* scr = static_cast<uint32_t*>(scratch);
  if (path == 0) return counted ? launch_register_wp<true>(a) : launch_register_wp<false>(a);
  if (table) return counted ? cudaErrorInvalidValue : launch_register_wp<false, true>(a);
  if (path == 1 || path == 4) return launch_lanes(a, path == 4);
  if (path == 2 || path == 3) {
    return counted ? launch_wide<true>(a, scr, path == 3) : launch_wide<false>(a, scr, path == 3);
  }
  return cudaErrorInvalidValue;
}
