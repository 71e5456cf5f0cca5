// K3: decrypt — per-chunk eq-all against the key mask, then a count or the
// per-chunk match bits.
//
// Replaces csgn_tpu/ops/kernels.py:decrypt_parity_pallas (count mode).  The
// per-chunk mode serves chunk_matches / SecretKey.decrypt_batch, which the
// JAX package leaves to XLA (csgn_tpu/ops/core.py:chunk_matches).
//
//   match[c] = AND over w of ((x[w, c] & m[w]) == m[w])
//   count    = sum_c match[c]          (kPerChunk = false; parity = count & 1)
//   out[c]   = match[c]                (kPerChunk = true)
//
// Bound on the H100: reading the words.  Design:
//   * one thread per kVec consecutive chunk columns, looping over the rows,
//     so each row is read coalesced across the warp (kVec = 4: one 16-byte
//     load per thread per row);
//   * the mask sits in shared memory, and rows whose mask word is zero are
//     skipped (x & 0 == 0 always holds): only the <= d rows that hold secret
//     positions are read, not all W;
//   * count mode: a warp sum and one 64-bit atomicAdd per warp that found a
//     match, into an int64 the wrapper zeroed (exact in any order).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kPerChunk, int kVec>
__global__ void __launch_bounds__(kThreads)
decrypt_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ mask,
               void* __restrict__ out, int64_t w, int64_t c) {
  extern __shared__ uint32_t sm_mask[];
  for (int64_t r = threadIdx.x; r < w; r += blockDim.x) sm_mask[r] = mask[r];
  __syncthreads();
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  const bool active = col0 < c;  // inactive lanes stay for the warp sum

  bool ok[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) ok[k] = true;
  if (active) {
    for (int64_t r = 0; r < w; ++r) {
      const uint32_t m = sm_mask[r];
      if (!m) continue;  // uniform across the block
      const uint32_t* row = x + r * c + col0;
      uint32_t v[kVec];
      if (kVec == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(row);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = row[k];
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) ok[k] &= (v[k] & m) == m;
    }
  }
  if (kPerChunk) {
    if (active) {
      int32_t* o = static_cast<int32_t*>(out) + col0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = ok[k] ? 1 : 0;
    }
  } else {
    unsigned n = 0;
    if (active) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) n += ok[k] ? 1u : 0u;
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if ((threadIdx.x & 31) == 0 && n)
      atomicAdd(static_cast<unsigned long long*>(out), static_cast<unsigned long long>(n));
  }
}

template <bool kPerChunk, int kVec>
cudaError_t launch(const void* x, const void* mask, void* out, int64_t w, int64_t c,
                   cudaStream_t stream) {
  const int64_t threads = (c + kVec - 1) / kVec;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(w) * sizeof(uint32_t);
  decrypt_kernel<kPerChunk, kVec><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(mask), out, w, c);
  return cudaGetLastError();
}

}  // namespace

// words [w, c], mask [w].  per_chunk = 0: adds the match count into the zeroed
// int64 `out`; per_chunk = 1: writes int32 out[c] match bits.  vec is 4 (needs
// c % 4 == 0 and 16-byte-aligned words) or 1.  Returns cudaGetLastError().
extern "C" int csgn_decrypt(const void* words, const void* mask, void* out, int64_t w,
                            int64_t c, int64_t per_chunk, int64_t vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  if (per_chunk) {
    return vec == 4 ? launch<true, 4>(words, mask, out, w, c, s)
                    : launch<true, 1>(words, mask, out, w, c, s);
  }
  return vec == 4 ? launch<false, 4>(words, mask, out, w, c, s)
                  : launch<false, 1>(words, mask, out, w, c, s);
}
