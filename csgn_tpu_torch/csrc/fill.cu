// K5: the write anchor, a constant fill at the aligned multiply's thread map.
//
// Replaces csgn_tpu/ops/kernels.py:fill_anchor_pallas, the JAX bench's
// same-job write speed-of-light anchor (bench.py:219-229, value_vs_anchor at
// 280-289): out [W, C] = value, C = t1*t2, written exactly as the aligned K1
// writes its product (csrc/mul.cu mul_kernel<_, 4, false>): 256 threads a
// block, one thread owns 4 consecutive columns and walks the W rows with one
// 16-byte store per row.  It differs from K1 only by K1's loads and ANDs, so
// K1's time over this one is what the loads cost.  There are no pad columns
// (the JAX fill pads t1 up to its block; the port's K1 has no pad).  When
// C % 4 != 0 the rows leave the 16-byte grid, and every thread stores its
// columns word by word (the tail thread only those below C).
//
// Bound on the H100: the W*C*4 bytes written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
fill_kernel(uint32_t* __restrict__ out, uint32_t value, int64_t w, int64_t c) {
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (col0 >= c) return;
  for (int64_t r = 0; r < w; ++r) {
    uint32_t* orow = out + r * c + col0;
    if (kVec16) {
      *reinterpret_cast<uint4*>(orow) = make_uint4(value, value, value, value);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (col0 + k < c) orow[k] = value;
      }
    }
  }
}

}  // namespace

// out uint32 [w, c] (16-byte aligned) = value.  Returns cudaGetLastError().
extern "C" int csgn_fill_anchor(void* out, int64_t value, int64_t w, int64_t c, void* stream) {
  const int64_t blocks = (c + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks > 0x7fffffff || blocks == 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  auto kernel = c % 4 == 0 ? fill_kernel<true> : fill_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<uint32_t>(value), w, c);
  return cudaGetLastError();
}
