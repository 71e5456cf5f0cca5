// K1 / K2: chunk cross-product AND, optionally fused with the decrypt count.
//
// Replaces csgn_tpu/ops/kernels.py:mul_chunks_pallas (K1) and
// csgn_tpu/ops/kernels.py:mul_decrypt_pallas (K2, `kCount`).
//
//   out[w, i*t2 + j] = a[w, i] & b[w, j]          (word-major [W, C], C = t1*t2)
//   count            = #{(i, j) : (a_i & b_j & m) == m on every word}
//
// Bound on the H100: the product write.  W*t1*t2*4 bytes leave the SM once and
// are never re-read; a and b are a few hundred KB and stay in L1/L2.  Design:
//   * one thread owns kVec consecutive output columns of the flat i-major
//     layout and walks all W rows, so a warp stores 32*kVec*4 contiguous bytes
//     per row (kVec = 4: one 16-byte store per thread) for ANY t1, t2 — the
//     canonical order needs no lane-alignment workaround on this card;
//   * (i, j) is derived once per thread (one 64-bit division), then reused
//     for the W rows; all offsets are 64-bit (W*t1*t2 passes 2^31 at
//     8192 x 8192);
//   * the count is strength-reduced as in kernels.py:140-154: a product
//     column matches iff its a-column and its b-column both match, so each
//     thread ANDs the a- and b-match bits over the mask's nonzero words only,
//     then a warp sum and one 64-bit atomicAdd per warp that found a match
//     (integer atomics are exact in any order; random chunks almost never
//     match, so the atomic is rare).  The product is never re-read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kCount, int kVec>
__global__ void __launch_bounds__(kThreads)
mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           const uint32_t* __restrict__ mask, uint32_t* __restrict__ out,
           unsigned long long* __restrict__ count, int64_t w, int64_t t1,
           int64_t t2) {
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

template <bool kCount, int kVec>
cudaError_t launch(const void* a, const void* b, const void* mask, void* out,
                   void* count, int64_t w, int64_t t1, int64_t t2,
                   cudaStream_t stream) {
  const int64_t threads = (t1 * t2 + kVec - 1) / kVec;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = kCount ? static_cast<size_t>(w) * sizeof(uint32_t) : 0;
  mul_kernel<kCount, kVec><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(mask), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(count), w, t1, t2);
  return cudaGetLastError();
}

}  // namespace

// a [w, t1], b [w, t2] -> out [w, t1*t2]; with `mask` [w] non-null, also adds
// the product's match count into the zeroed int64 `count`.  vec is 4 (needs
// t1*t2 % 4 == 0 and a 16-byte-aligned out) or 1.  Returns cudaGetLastError().
extern "C" int csgn_mul(const void* a, const void* b, const void* mask, void* out,
                        void* count, int64_t w, int64_t t1, int64_t t2, int64_t vec,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  if (mask != nullptr) {
    return vec == 4 ? launch<true, 4>(a, b, mask, out, count, w, t1, t2, s)
                    : launch<true, 1>(a, b, mask, out, count, w, t1, t2, s);
  }
  return vec == 4 ? launch<false, 4>(a, b, mask, out, count, w, t1, t2, s)
                  : launch<false, 1>(a, b, mask, out, count, w, t1, t2, s);
}
