// The chunk cross-product AND, optionally fused with the decrypt count, in
// three modes that share one contract:
//
//   out[w, i*t2 + j] = a[w, i] & b[w, j]          (word-major [W, C], C = t1*t2)
//   count            = #{(i, j) : (a_i & b_j & m) == m on every word}
//
//   * aligned (K1 / K2): rows start on 16-byte boundaries (C % 4 == 0).
//     Replaces csgn_tpu/ops/kernels.py:mul_chunks_pallas (K1) and
//     :mul_decrypt_pallas (K2, `kCount`).
//   * unaligned (K10, K11a, K11b): any C.  Replaces :mul_chunks_pallas_grouped
//     (K10), :mul_chunks_pallas_tiled_ragged (K11a) and
//     :mul_decrypt_pallas_tiled_ragged (K11b), which exist for Mosaic's
//     128-lane alignment; here the product has no pad chunks.
//   * b-streamed (K6a, K6b): b beyond L2.  Replaces :mul_chunks_pallas_tiled
//     (K6a) and :mul_decrypt_pallas_tiled (K6b).
//
// Batched operands [B, W, t] (the JAX package vmaps the same kernels,
// csgn_tpu/ops/dispatch.py:354, 438) take element e from blockIdx.y, with
// 64-bit element strides and a per-element count[e]; a 2-D call is B = 1.
// The host launches one grid per 65535 elements.  Only the `kBatched`
// instantiations apply the element offset: a 2-D call (or B = 1) runs the
// 2-D kernel's exact code, because on an H100 the offset alone slowed the
// 2-D K1 by 6 % and K2 by 13 %.
//
// Bound on the H100: the product write.  W*t1*t2*4 bytes leave the SM once and
// are never re-read; a and b are read from L1/L2.  Design of the aligned mode:
//   * one thread owns kVec consecutive output columns of the flat i-major
//     layout and walks all W rows, so a warp stores 32*kVec*4 contiguous bytes
//     per row (kVec = 4: one 16-byte store per thread);
//   * (i, j) is derived once per thread (one 64-bit division), then reused
//     for the W rows; all offsets are 64-bit (W*t1*t2 passes 2^31 at
//     8192 x 8192);
//   * the count is strength-reduced as in kernels.py:140-154: a product
//     column matches iff its a-column and its b-column both match, so each
//     thread ANDs the a- and b-match bits over the mask's nonzero words only,
//     then a warp sum and one 64-bit atomicAdd per warp that found a match
//     (integer atomics are exact in any order; random chunks almost never
//     match, so the atomic is rare).  The product is never re-read.
//
// Unaligned mode: when C % 4 != 0, row r starts at word r*C, so a fixed
// column-to-thread map leaves three rows in four off the 16-byte grid.  Each
// block owns a range of kTile product columns in every row; a thread owns one
// 16-byte slot of the row's ABSOLUTE address grid, so the slots shift with
// the row's offset o = (address of the range's first column / 4) % 4.  Rows
// r0, r0 + 4, r0 + 8, ... share o, so a thread derives its four (i, j) once
// per residue r0 and walks those rows; a slot wholly inside the range is one
// 16-byte store, and only the slots at the range's head and tail store word
// by word.  kTile = 4 * kThreads - 4 keeps every offset inside the block's
// kThreads slots.
//
// b-streamed mode: the aligned and unaligned modes walk the product i-major,
// so they read all of b once per a-column; that is free while b sits in the
// 50 MB L2 and costs a second HBM stream once it does not.  Here block L
// takes b tile L / t1 (kTile columns) and a-column L % t1: the blocks that
// run together share a few b tiles, each tile is fetched from HBM once and
// swept from L2 across all t1 a-columns (K6's grid (t2 // bt, t1),
// kernels.py:264, 405).  The stores are the unaligned mode's, so a large
// unaligned b takes both.
//
// The count of these two modes no longer walks whole product columns.  It is
// (#matching a-columns) * (#matching b-columns) per element (exact; the
// identity kernels.py:140-154 and 530-543 strength-reduce to): the element's
// threads test a's t1 and b's t2 columns over the mask's nonzero words, add
// the two sums into scratch[e] with atomics, and the element's last block to
// finish (a ticket in scratch[e]) writes count[e] = na * nb.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kTile = 4 * kThreads - 4;

template <bool kCount, int kVec, bool kBatched>
__global__ void __launch_bounds__(kThreads)
mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           const uint32_t* __restrict__ mask, uint32_t* __restrict__ out,
           unsigned long long* __restrict__ count, int64_t w, int64_t t1,
           int64_t t2) {
  if (kBatched) {
    const int64_t e = blockIdx.y;
    a += e * w * t1;
    b += e * w * t2;
    out += e * w * t1 * t2;
    if (kCount) count += e;
  }
  extern __shared__ uint32_t sm_mask[];
  if (kCount) {
    for (int64_t r = threadIdx.x; r < w; r += blockDim.x) sm_mask[r] = mask[r];
    __syncthreads();
  }
  const int64_t c = t1 * t2;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  const bool active = col0 < c;  // inactive lanes stay for the warp sum

  int64_t ai[kVec], bj[kVec];
  bool ma[kVec], mb[kVec];
  if (active) {
    int64_t i = col0 / t2, j = col0 - i * t2;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      ai[k] = i;
      bj[k] = j;
      ma[k] = mb[k] = true;
      if (++j == t2) { j = 0; ++i; }
    }
    for (int64_t r = 0; r < w; ++r) {
      const uint32_t* arow = a + r * t1;
      const uint32_t* brow = b + r * t2;
      uint32_t v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const uint32_t x = arow[ai[k]], y = brow[bj[k]];
        v[k] = x & y;
        if (kCount) {
          const uint32_t m = sm_mask[r];
          if (m) {  // uniform across the block: the mask is shared
            ma[k] &= (x & m) == m;
            mb[k] &= (y & m) == m;
          }
        }
      }
      uint32_t* orow = out + r * c + col0;
      if (kVec == 4) {
        *reinterpret_cast<uint4*>(orow) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) orow[k] = v[k];
      }
    }
  }
  if (kCount) {
    unsigned n = 0;
    if (active) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) n += (ma[k] && mb[k]) ? 1u : 0u;
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(count, static_cast<unsigned long long>(n));
  }
}

// 1 if column k of x [w, t] matches the mask on every nonzero mask word.
__device__ __forceinline__ unsigned column_matches(const uint32_t* __restrict__ x, int64_t t,
                                                   int64_t k, const uint32_t* sm_mask,
                                                   int64_t w) {
  bool ok = true;
  for (int64_t r = 0; r < w; ++r) {
    const uint32_t m = sm_mask[r];
    if (m) ok &= (x[r * t + k] & m) == m;
  }
  return ok ? 1u : 0u;
}

// The launch bound of six blocks per SM caps the kernel at 40 registers, as
// the aligned K1 has (at 64 registers only four blocks fit, and the same
// stores ran 10-19 % slower on an H100).  Column indices are 32-bit
// (t1, t2 < 2^32).
template <bool kCount, bool kStreamB, bool kBatched>
__global__ void __launch_bounds__(kThreads, 6)
mul_ragged_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  const uint32_t* __restrict__ mask, uint32_t* __restrict__ out,
                  unsigned long long* __restrict__ count,
                  unsigned long long* __restrict__ scratch, int64_t w, int64_t t1,
                  int64_t t2) {
  if (kBatched) {
    const int64_t e = blockIdx.y;
    a += e * w * t1;
    b += e * w * t2;
    out += e * w * t1 * t2;
    if (kCount) {
      count += e;
      scratch += 3 * e;
    }
  }
  extern __shared__ uint32_t sm_mask[];
  if (kCount) {
    for (int64_t r = threadIdx.x; r < w; r += blockDim.x) sm_mask[r] = mask[r];
    __syncthreads();
  }
  const int64_t c = t1 * t2;
  int64_t cs, ce, i_blk = 0;  // this block's product columns [cs, ce)
  if (kStreamB) {
    const int64_t tile = blockIdx.x / t1;  // a-column innermost
    i_blk = blockIdx.x - tile * t1;
    const int64_t j0 = tile * kTile;
    cs = i_blk * t2 + j0;
    ce = i_blk * t2 + (j0 + kTile < t2 ? j0 + kTile : t2);
  } else {
    cs = static_cast<int64_t>(blockIdx.x) * kTile;
    ce = cs + kTile < c ? cs + kTile : c;
  }

  const int residues = w < 4 ? static_cast<int>(w) : 4;
  for (int r0 = 0; r0 < residues; ++r0) {
    uint32_t* dst = out + r0 * c + cs;
    const int o = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    const int64_t col0 = cs - o + 4 * static_cast<int64_t>(threadIdx.x);
    const int64_t first = col0 > cs ? col0 : cs;
    const uint32_t t2u = static_cast<uint32_t>(t2);
    uint32_t i, j;  // of column `first`
    if (kStreamB) {
      i = static_cast<uint32_t>(i_blk);
      j = static_cast<uint32_t>(first - i_blk * t2);
    } else {
      const int64_t i64 = first / t2;
      i = static_cast<uint32_t>(i64);
      j = static_cast<uint32_t>(first - i64 * t2);
    }
    uint32_t ai[4], bj[4];
    bool ok[4];
    bool all = true, any = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t col = col0 + q;
      ok[q] = col >= cs && col < ce;
      all &= ok[q];
      any |= ok[q];
      ai[q] = ok[q] ? i : 0u;
      bj[q] = ok[q] ? j : 0u;
      if (ok[q] && ++j == t2u) { j = 0; ++i; }
    }
    if (!any) continue;
    const uint32_t* arow = a + r0 * t1;
    const uint32_t* brow = b + r0 * t2;
    dst += 4 * static_cast<int64_t>(threadIdx.x) - o;  // 16-byte aligned by the choice of o
    const int64_t astep = 4 * t1, bstep = 4 * t2, ostep = 4 * c;
    for (int r = r0; r < w; r += 4, arow += astep, brow += bstep, dst += ostep) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = arow[ai[q]] & brow[bj[q]];
      if (all) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (ok[q]) dst[q] = v[q];
        }
      }
    }
  }

  if (kCount) {
    const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    unsigned na = 0, nb = 0;
    for (int64_t k = g; k < t1; k += nthreads) na += column_matches(a, t1, k, sm_mask, w);
    for (int64_t k = g; k < t2; k += nthreads) nb += column_matches(b, t2, k, sm_mask, w);
    na = __reduce_add_sync(0xffffffffu, na);
    nb = __reduce_add_sync(0xffffffffu, nb);
    if ((threadIdx.x & 31) == 0) {
      if (na) atomicAdd(scratch, static_cast<unsigned long long>(na));
      if (nb) atomicAdd(scratch + 1, static_cast<unsigned long long>(nb));
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long ticket = atomicAdd(scratch + 2, 1ull);
      if (ticket == gridDim.x - 1) {  // every block of the element has added
        __threadfence();
        *count = atomicAdd(scratch, 0ull) * atomicAdd(scratch + 1, 0ull);
      }
    }
  }
}

template <bool kCount, int kVec>
cudaError_t launch(const void* a, const void* b, const void* mask, void* out,
                   void* count, int64_t batch, int64_t w, int64_t t1, int64_t t2,
                   cudaStream_t stream) {
  const int64_t threads = (t1 * t2 + kVec - 1) / kVec;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = kCount ? static_cast<size_t>(w) * sizeof(uint32_t) : 0;
  for (int64_t e0 = 0; e0 < batch; e0 += kMaxGridY) {
    const int64_t n = batch - e0 < kMaxGridY ? batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    auto kernel = n > 1 ? mul_kernel<kCount, kVec, true> : mul_kernel<kCount, kVec, false>;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(a) + e0 * w * t1,
        static_cast<const uint32_t*>(b) + e0 * w * t2,
        static_cast<const uint32_t*>(mask), static_cast<uint32_t*>(out) + e0 * w * t1 * t2,
        static_cast<unsigned long long*>(count) + (count ? e0 : 0), w, t1, t2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kCount, bool kStreamB>
cudaError_t launch_ragged(const void* a, const void* b, const void* mask, void* out,
                          void* count, void* scratch, int64_t batch, int64_t w, int64_t t1,
                          int64_t t2, cudaStream_t stream) {
  const int64_t blocks =
      kStreamB ? t1 * ((t2 + kTile - 1) / kTile) : (t1 * t2 + kTile - 1) / kTile;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = kCount ? static_cast<size_t>(w) * sizeof(uint32_t) : 0;
  for (int64_t e0 = 0; e0 < batch; e0 += kMaxGridY) {
    const int64_t n = batch - e0 < kMaxGridY ? batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    auto kernel = n > 1 ? mul_ragged_kernel<kCount, kStreamB, true>
                        : mul_ragged_kernel<kCount, kStreamB, false>;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(a) + e0 * w * t1,
        static_cast<const uint32_t*>(b) + e0 * w * t2,
        static_cast<const uint32_t*>(mask), static_cast<uint32_t*>(out) + e0 * w * t1 * t2,
        static_cast<unsigned long long*>(count) + (count ? e0 : 0),
        static_cast<unsigned long long*>(scratch) + (scratch ? 3 * e0 : 0), w, t1, t2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kCount>
cudaError_t launch_mode(const void* a, const void* b, const void* mask, void* out, void* count,
                        void* scratch, int64_t batch, int64_t w, int64_t t1, int64_t t2,
                        int64_t mode, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<kCount, 1>(a, b, mask, out, count, batch, w, t1, t2, s);
    case 1: return launch<kCount, 4>(a, b, mask, out, count, batch, w, t1, t2, s);
    case 2: return launch_ragged<kCount, false>(a, b, mask, out, count, scratch, batch, w, t1,
                                                t2, s);
    default: return launch_ragged<kCount, true>(a, b, mask, out, count, scratch, batch, w, t1,
                                                t2, s);
  }
}

}  // namespace

// a [batch, w, t1], b [batch, w, t2] -> out [batch, w, t1*t2]; with `mask`
// [w] non-null, also adds element e's match count into the zeroed int64
// count[e].  mode: 0 = aligned walk with 4-byte stores, 1 = aligned (K1/K2;
// needs t1*t2 % 4 == 0 and a 16-byte-aligned out), 2 = unaligned,
// 3 = b-streamed.  Modes 2 and 3 take t1, t2 < 2^32 and, with a mask,
// `scratch`, int64 [batch, 3] zeroed.  Launches ceil(batch / 65535) grids.  Returns
// cudaGetLastError().
extern "C" int csgn_mul(const void* a, const void* b, const void* mask, void* out,
                        void* count, void* scratch, int64_t batch, int64_t w, int64_t t1,
                        int64_t t2, int64_t mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 3) return cudaErrorInvalidValue;
  if (mode == 1 && ((t1 * t2) % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (mode >= 2 && ((mask != nullptr && scratch == nullptr) || t1 > 0xffffffffll ||
                    t2 > 0xffffffffll)) {
    return cudaErrorInvalidValue;
  }
  if (mask != nullptr) {
    return launch_mode<true>(a, b, mask, out, count, scratch, batch, w, t1, t2, mode, s);
  }
  return launch_mode<false>(a, b, mask, out, count, scratch, batch, w, t1, t2, mode, s);
}
