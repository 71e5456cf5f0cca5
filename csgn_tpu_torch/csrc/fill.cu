// K5: the write anchor, a constant fill at the card's write floor.
//
// Replaces csgn_tpu/ops/kernels.py:fill_anchor_pallas, the JAX bench's
// same-job write speed-of-light anchor (bench.py:219-229, value_vs_anchor at
// 280-289): out [W, C] = value, C = t1*t2.  The output is one contiguous
// buffer of W*C words, so the fill ignores its rows: block i writes the
// 16 KB [16 KB * i, 16 KB * (i + 1)) of it, each thread kVec 16-byte
// streaming stores (st.global.cs, so the fill does not keep its lines in
// L2), neighbouring threads on neighbouring addresses; block 0 also stores
// the last W*C % 4 words one by one.  One short-lived block per 16 KB wrote
// faster on the H100 than a grid of resident blocks striding over the buffer,
// which stays below Tensor.fill_.  Anchor / K1 is therefore K1's share of the
// write floor.  There are no pad columns (the JAX fill pads t1 up to its
// block).
//
// Bound on the H100: the W*C*4 bytes written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // 16-byte stores per thread
constexpr int64_t kBlockVecs = int64_t{kThreads} * kVec;

__global__ void __launch_bounds__(kThreads)
fill_kernel(uint32_t* __restrict__ out, uint32_t value, int64_t n) {
  uint4* out16 = reinterpret_cast<uint4*>(out);
  const int64_t n16 = n / 4;
  const uint4 v = make_uint4(value, value, value, value);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlockVecs + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < n16) __stcs(out16 + i, v);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n16) out[4 * n16 + threadIdx.x] = value;
}

}  // namespace

// out uint32 [w, c] (16-byte aligned) = value.  Returns cudaGetLastError().
extern "C" int csgn_fill_anchor(void* out, int64_t value, int64_t w, int64_t c, void* stream) {
  const int64_t n = w * c;
  const int64_t blocks = (n / 4 + kBlockVecs - 1) / kBlockVecs;  // 0 when n < 4: the tail only
  if (n <= 0 || blocks > 0x7fffffff || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  fill_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out),
                                                     static_cast<uint32_t>(value), n);
  return cudaGetLastError();
}
