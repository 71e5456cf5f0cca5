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
//                         exchange the bits of m[r]:  t = (x[r] ^ x[r+R]) & m[r]
//   count (kCount)      = #{chunks : (out & key) == key on every word}
//
// The pairwise form of the cross-word stage is the roll form of the plain
// version (permute_benes.py `_delta_swap`) because a plan's mask rows are
// zero wherever bit R of the row is set (`_route` marks only positions with
// (i & delta) == 0), so the partner row r + R never wraps.
//
// Bound on the H100: integer issue and shared memory, not HBM.  Each chunk
// is read and written once (W words each way), but every one of its <= 2m-1
// stages (21 at n = 1247) touches up to WP = 64 rows with ~6 integer ops and
// two shared-memory accesses per row.  Design:
//   * one thread owns one chunk column for the whole network: it loads the
//     column into shared memory as tile[row][thread] (row-major with stride
//     blockDim.x, so a warp's accesses to one row hit 32 distinct banks),
//     runs every live stage there and stores the column once.  Threads
//     never read each other's columns, so the stages need no barrier;
//   * rows [w_net, WP) start as zeros (the network's padding); output rows
//     [w_net, W) are stored as zeros (n < 32, where W = 2 > WP = 1);
//   * the schedule (delta, live rows; rows 0 = stage off in every plan) and
//     the plan's masks [S, WP] are staged in shared memory once per block;
//     a mask word is the same for every thread, so a zero word skips its
//     row with a branch that never diverges;
//   * batch element b comes from blockIdx.y (the host launches one grid per
//     65535 elements) and selects plan masks + b * plan_stride;
//   * the count is a per-thread eq-all over the output column, a warp sum
//     and one 64-bit atomicAdd per warp that found a match (exact in any
//     order), into count[b];
//   * all offsets are 64-bit ([k, W, C] with k*C = 2^24 passes 2^31 words);
//     the ragged last column block is bounds-checked, not padded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // chunk columns per block (at most)
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int64_t kMaxGridY = 65535;

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
benes_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ masks,
             const int32_t* __restrict__ sched, const uint32_t* __restrict__ key,
             uint32_t* __restrict__ out, unsigned long long* __restrict__ count,
             int64_t w, int64_t c, int wp, int stages, int w_net, int64_t plan_stride) {
  const int64_t b = blockIdx.y;
  extern __shared__ uint32_t smem[];
  const int bc = blockDim.x;
  uint32_t* tile = smem;                                   // [wp][bc]
  uint32_t* sm_masks = tile + static_cast<size_t>(wp) * bc;  // [stages][wp]
  int32_t* sm_sched = reinterpret_cast<int32_t*>(sm_masks + stages * wp);  // [stages][2]
  uint32_t* sm_key = reinterpret_cast<uint32_t*>(sm_sched + 2 * stages);   // [w]

  const uint32_t* mb = masks + b * plan_stride;
  for (int i = threadIdx.x; i < stages * wp; i += bc) sm_masks[i] = mb[i];
  for (int i = threadIdx.x; i < 2 * stages; i += bc) sm_sched[i] = sched[i];
  if (kCount) {
    for (int64_t r = threadIdx.x; r < w; r += bc) sm_key[r] = key[r];
  }
  __syncthreads();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * bc + threadIdx.x;
  const bool active = col < c;  // inactive lanes stay for the warp sum
  uint32_t* my = tile + threadIdx.x;
  bool ok = true;
  if (active) {
    const uint32_t* src = x + b * w * c + col;
    for (int r = 0; r < w_net; ++r) my[r * bc] = src[r * c];
    for (int r = w_net; r < wp; ++r) my[r * bc] = 0u;

    for (int s = 0; s < stages; ++s) {
      const int delta = sm_sched[2 * s];
      const int rows = sm_sched[2 * s + 1];
      const uint32_t* m = sm_masks + s * wp;
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
        const uint32_t k = sm_key[r];
        if (!k) continue;  // uniform across the block
        const uint32_t v = r < w_net ? my[r * bc] : 0u;
        ok &= (v & k) == k;
      }
    }
  }
  if (kCount) {
    unsigned n = __reduce_add_sync(0xffffffffu, (active && ok) ? 1u : 0u);
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(count + b, static_cast<unsigned long long>(n));
  }
}

template <bool kCount>
cudaError_t launch(const void* x, const void* masks, const void* sched, const void* key,
                   void* out, void* count, int64_t batch, int64_t w, int64_t c, int64_t wp,
                   int64_t stages, int64_t w_net, int64_t plan_stride, cudaStream_t stream) {
  // (b, plan, count) of grid-y slice [e0, e0 + 65535) come in through offset
  // base pointers, so b restarts at 0 in every slice.
  auto smem_for = [&](int64_t bc) {
    return static_cast<size_t>(wp * bc + stages * wp + 2 * stages + (kCount ? w : 0)) *
           sizeof(uint32_t);
  };
  int64_t bc = kThreads;
  while (bc > 32 && smem_for(bc) > kSmemLimit) bc /= 2;
  const size_t smem = smem_for(bc);
  if (smem > kSmemLimit || w_net > wp || w_net > w) return cudaErrorInvalidValue;
  const int64_t blocks = (c + bc - 1) / bc;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        benes_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  for (int64_t e0 = 0; e0 < batch; e0 += kMaxGridY) {
    const int64_t n = batch - e0 < kMaxGridY ? batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    benes_kernel<kCount><<<grid, static_cast<unsigned>(bc), smem, stream>>>(
        static_cast<const uint32_t*>(x) + e0 * w * c,
        static_cast<const uint32_t*>(masks) + e0 * plan_stride,
        static_cast<const int32_t*>(sched), static_cast<const uint32_t*>(key),
        static_cast<uint32_t*>(out) + e0 * w * c,
        static_cast<unsigned long long*>(count) + (count ? e0 : 0), w, c,
        static_cast<int>(wp), static_cast<int>(stages), static_cast<int>(w_net), plan_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x [batch, w, c] -> out [batch, w, c]; masks [*, stages, wp] with element b
// using masks + b * plan_stride (0: one plan for all); sched int32
// [stages, 2] of (delta, live rows).  With `key` [w] non-null, also adds
// element b's match count into the zeroed int64 count[b].  Launches
// ceil(batch / 65535) grids.  Returns cudaGetLastError().
extern "C" int csgn_benes(const void* x, const void* masks, const void* sched, const void* key,
                          void* out, void* count, int64_t batch, int64_t w, int64_t c,
                          int64_t wp, int64_t stages, int64_t w_net, int64_t plan_stride,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key != nullptr) {
    return launch<true>(x, masks, sched, key, out, count, batch, w, c, wp, stages, w_net,
                        plan_stride, s);
  }
  return launch<false>(x, masks, sched, key, out, count, batch, w, c, wp, stages, w_net,
                       plan_stride, s);
}
