// The Beneš network's stage arithmetic on a column of words held in
// registers, and the launch plumbing, shared by the kernels of benes.cu (the
// register and wide paths) and benes_lanes.cu (the lane-group path).  See
// benes.cu for the network, its plan and the bound on the H100.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace benes {

constexpr size_t kSmemLimit = 227 * 1024;
constexpr int64_t kMaxGridY = 65535;

__host__ __device__ __forceinline__ int64_t key_words(int64_t w, int64_t wp, bool count) {
  return count ? (w > wp ? w : wp) : 0;
}

// Adds the warp's matching lanes to *count: one 64-bit atomic per warp that
// found a match (exact in any order).
__device__ __forceinline__ void add_matches(unsigned long long* count, bool match) {
  const unsigned n = __reduce_add_sync(0xffffffffu, match ? 1u : 0u);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(count, static_cast<unsigned long long>(n));
}

// Mask words [r, r + N) of one stage; N = 4 is one 16-byte load (a broadcast
// where the warp's lanes share the address).
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

// One stage on a column of N words in registers, `col[i]` being row i of the
// thread's part of the network and `rows` its live rows.  Rows go in groups
// of G = min(N, 8), the live window's granularity, and masks in quads of
// Q = min(N, 4) rows; quad k of the thread's mask words starts at m + k * S
// (S = Q: the words are contiguous; the lane-group path interleaves the
// quads of its lanes).  `rows` is tested once per group, so a window that
// is uniform across the warp never diverges.
template <int N, int S = (N < 4 ? N : 4)>
__device__ __forceinline__ void in_word(uint32_t (&col)[N], const uint32_t* m, int d, int rows) {
  constexpr int G = N < 8 ? N : 8;
  constexpr int Q = N < 4 ? N : 4;
#pragma unroll
  for (int g = 0; g < N; g += G) {
    if (g < rows) {
#pragma unroll
      for (int q = g; q < g + G; q += Q) {
        uint32_t mk[Q];
        load_masks<Q>(mk, m + q / Q * S);
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

// Rows r and r + R of the column (bit R of r clear) exchange the bits of
// the lower row's mask word.
template <int N, int R, int S = (N < 4 ? N : 4)>
__device__ __forceinline__ void cross_word(uint32_t (&col)[N], const uint32_t* m, int rows) {
  if constexpr (R < N) {
    constexpr int G = N < 8 ? N : 8;
    constexpr int Q = N < 4 ? N : 4;
#pragma unroll
    for (int g = 0; g < N; g += G) {
      if (g < rows) {
#pragma unroll
        for (int q = g; q < g + G; q += Q) {
          if (R < Q || (q & R) == 0) {  // the quad holds a lower row of a pair
            uint32_t mk[Q];
            load_masks<Q>(mk, m + q / Q * S);
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              if (((q + i) & R) == 0) {
                constexpr int kMask = N - 1;  // keeps dead branches' indices in range
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

// Every row of the column exchanges the bits of mask word m with the same
// row of lane (lane ^ x), both lanes reading the lower lane's mask: one
// shuffle and one bit select a word.  `rows` must be uniform across the warp
// (every lane takes part in every shuffle).
template <int N, int S>
__device__ __forceinline__ void exchange(uint32_t (&col)[N], const uint32_t* m, int x, int rows) {
  constexpr int G = N < 8 ? N : 8;
#pragma unroll
  for (int g = 0; g < N; g += G) {
    if (g < rows) {
#pragma unroll
      for (int q = g; q < g + G; q += 4) {
        uint32_t mk[4];
        load_masks<4>(mk, m + q / 4 * S);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t other = __shfl_xor_sync(0xffffffffu, col[q + i], x);
          col[q + i] = (col[q + i] & ~mk[i]) | (other & mk[i]);
        }
      }
    }
  }
}

// A kernel's words and plans: the batch's words [batch, w, c] and its
// plans' masks plan_stride words apart, or (kTable) a device table of 2 *
// batch pointers, element b's words [w, c] at table[b] and its plan's masks
// [stages, wp] at table[batch + b], each wherever it is stored.
template <bool kTable>
using Source = std::conditional_t<kTable, const uint32_t* const*, const uint32_t*>;

struct Args {
  const uint32_t* x;
  const uint32_t* masks;
  const int32_t* sched;
  const uint32_t* key;
  uint32_t* out;
  unsigned long long* count;
  int64_t batch, w, c, wp, stages, w_net, plan_stride;
  cudaStream_t stream;
  const uint32_t* const* table = nullptr;  // the table form's, in place of x and masks
};

// Element e0's words and its plan's masks (kTable: their entries of the table).
template <bool kTable>
Source<kTable> slice_words(const Args& a, int64_t e0) {
  if constexpr (kTable) {
    return a.table + e0;
  } else {
    return a.x + e0 * a.w * a.c;
  }
}

template <bool kTable>
Source<kTable> slice_masks(const Args& a, int64_t e0) {
  if constexpr (kTable) {
    return a.table + a.batch + e0;
  } else {
    return a.masks + e0 * a.plan_stride;
  }
}

// Launches kernel(e0 slice args...) with `threads` threads a block over
// ceil(c / chunks) blocks, once per 65535 batch elements; the slice's (b,
// input, plan, count) come in through offset base pointers, so b restarts at
// 0 in every slice.
template <bool kTable = false, typename Kernel, typename... Tail>
cudaError_t launch_slices(Kernel kernel, const Args& a, int64_t chunks, int threads, size_t smem,
                          Tail... tail) {
  const int64_t blocks = (a.c + chunks - 1) / chunks;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  for (int64_t e0 = 0; e0 < a.batch; e0 += kMaxGridY) {
    const int64_t n = a.batch - e0 < kMaxGridY ? a.batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    kernel<<<grid, static_cast<unsigned>(threads), smem, a.stream>>>(
        slice_words<kTable>(a, e0), slice_masks<kTable>(a, e0), a.sched, a.key,
        a.out + e0 * a.w * a.c, a.count + (a.count ? e0 : 0), a.w, a.c, tail...,
        static_cast<int>(a.stages), static_cast<int>(a.w_net), a.plan_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The lane-group path (benes_lanes.cu): a.wp in {128, ..., 2048}, a.masks in
// the lane layout (ops/benes_kernels.py `lane_masks`); `ring` takes the ring
// form, which needs wp = 128, c % 4 == 0 and x, out 16-byte aligned
// (ops/benes_kernels.py `lanes_form`).
cudaError_t launch_lanes(const Args& a, bool ring);

}  // namespace benes
