// The chunk cross-product AND, optionally followed by the decrypt count, in
// three modes that share one contract:
//
//   out[w, i*t2 + j] = a[w, i] & b[w, j]          (word-major [W, C], C = t1*t2)
//   count            = #{(i, j) : (a_i & b_j & m) == m on every word}
//
//   * aligned (K1): rows start on 16-byte boundaries (C % 4 == 0).
//     Replaces csgn_tpu/ops/kernels.py:mul_chunks_pallas (K1).
//   * unaligned (K10, K11a): any C.  Replaces :mul_chunks_pallas_grouped
//     (K10) and :mul_chunks_pallas_tiled_ragged (K11a), which exist for
//     Mosaic's 128-lane alignment; here the product has no pad chunks.
//   * b-streamed (K6a): b beyond L2.  Replaces :mul_chunks_pallas_tiled (K6a).
//
// The fused forms (:mul_decrypt_pallas K2, :mul_decrypt_pallas_tiled K6b,
// :mul_decrypt_pallas_tiled_ragged K11b) are the mode's product kernel above
// followed, on the same stream, by the column-match pass (match_count_kernel).
// A product column (i, j) matches iff a's column i and b's column j both
// match (the identity kernels.py:140-154 and 530-543 strength-reduce to), so
// count = (#matching a-columns) * (#matching b-columns), exact, written (not
// accumulated) per element.  The pass reads only the rows of the mask's
// nonzero words of a and b, t1 + t2 columns: 0.4 MB at 4096 x 4096 against
// the product's 2.7 GB, and the product kernels carry no count at all.
//
// Batched operands [B, W, t] (the JAX package vmaps the same kernels,
// csgn_tpu/ops/dispatch.py:354, 438) take element e from blockIdx.y, with
// 64-bit element strides and a per-element count[e]; a 2-D call is B = 1.
// The host launches one grid per 65535 elements.  Only the `kBatched`
// instantiations apply the element offset: a 2-D call (or B = 1) runs the
// 2-D kernel's exact code, because on an H100 the offset alone slowed the
// 2-D K1 by 6 %.
//
// Bound on the H100: the product write.  W*t1*t2*4 bytes leave the SM once and
// are never re-read; a and b are read from L1/L2.  Design of the aligned mode:
//   * one thread owns kVec consecutive output columns of the flat i-major
//     layout and walks all W rows, so a warp stores 32*kVec*4 contiguous bytes
//     per row (kVec = 4: one 16-byte store per thread);
//   * (i, j) is derived once per thread (one 64-bit division), then reused
//     for the W rows; all offsets are 64-bit (W*t1*t2 passes 2^31 at
//     8192 x 8192).
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kTile = 4 * kThreads - 4;

// kVec is always 4; it stays a template argument so that the kernel keeps its
// name, mul_kernel<4, ...>, in device traces.
template <int kVec, bool kBatched>
__global__ void __launch_bounds__(kThreads)
mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int64_t w, int64_t t1, int64_t t2) {
  static_assert(kVec == 4, "one 16-byte store a thread");
  if (kBatched) {
    const int64_t e = blockIdx.y;
    a += e * w * t1;
    b += e * w * t2;
    out += e * w * t1 * t2;
  }
  const int64_t c = t1 * t2;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  const bool active = col0 < c;

  int64_t ai[kVec], bj[kVec];
  if (active) {
    int64_t i = col0 / t2, j = col0 - i * t2;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      ai[k] = i;
      bj[k] = j;
      if (++j == t2) { j = 0; ++i; }
    }
    for (int64_t r = 0; r < w; ++r) {
      const uint32_t* arow = a + r * t1;
      const uint32_t* brow = b + r * t2;
      uint32_t v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = arow[ai[k]] & brow[bj[k]];
      uint32_t* orow = out + r * c + col0;
      *reinterpret_cast<uint4*>(orow) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The launch bound of six blocks per SM caps the kernel at 40 registers, as
// the aligned K1 has (at 64 registers only four blocks fit, and the same
// stores ran 10-19 % slower on an H100).  Column indices are 32-bit
// (t1, t2 < 2^32).
template <bool kStreamB, bool kBatched>
__global__ void __launch_bounds__(kThreads, 6)
mul_ragged_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  uint32_t* __restrict__ out, int64_t w, int64_t t1, int64_t t2) {
  if (kBatched) {
    const int64_t e = blockIdx.y;
    a += e * w * t1;
    b += e * w * t2;
    out += e * w * t1 * t2;
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
}

// The count of a fused call: count[e] = na * nb, where na of a's t1 columns
// and nb of b's t2 columns match the mask on every nonzero mask word.  Below
// a few MB of operand rows the pass takes as long as its chain of dependent
// memory round trips, so it keeps the chain short.  A block first lists the
// rows of the mask's nonzero words in shared memory (in any order: an AND
// does not care), then sweeps the element's t1 + t2 columns (a's, then b's),
// kCountCols a thread kCountThreads apart so that a warp's loads of one row
// are contiguous, and kCountSpan a block a sweep; for each column it loads
// kCountRows of the listed rows, and their mask words, at once, and stops
// once the column fails.  At most kCountMaxBlocks blocks an element (three
// blocks at 80 registers a thread fit on each of the H100's 132 SMs), so a
// long element takes several sweeps rather than several waves of blocks,
// shared evenly.  With one block an element, the block writes count[e]; with
// more, each block adds (na << 32 | nb) into scratch[e][0] (zeroed by the
// host; t1, t2 < 2^32) and the element's last block to finish (a ticket in
// scratch[e][1]) writes count[e].
constexpr int kCountThreads = 256;
constexpr int kCountCols = 2;
constexpr int kCountRows = 16;
constexpr int64_t kCountSpan = kCountThreads * kCountCols;
constexpr int64_t kCountMaxBlocks = 3 * 132;

__global__ void __launch_bounds__(kCountThreads)
match_count_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   const uint32_t* __restrict__ mask, unsigned long long* __restrict__ count,
                   unsigned long long* __restrict__ scratch, int64_t w, int64_t t1,
                   int64_t t2) {
  extern __shared__ uint32_t rows[];  // [w]: the rows of the mask's nonzero words
  __shared__ unsigned nnz, sums[kCountThreads / 32][2];
  const int64_t e = blockIdx.y;
  a += e * w * t1;
  b += e * w * t2;
  if (threadIdx.x == 0) nnz = 0;
  __syncthreads();
  for (int64_t r = threadIdx.x; r < w; r += kCountThreads) {
    if (mask[r]) rows[atomicAdd(&nnz, 1u)] = static_cast<uint32_t>(r);
  }
  __syncthreads();
  const unsigned n = nnz;
  unsigned na = 0, nb = 0;
  for (int64_t k0 = blockIdx.x * kCountSpan + threadIdx.x; k0 < t1 + t2;
       k0 += gridDim.x * kCountSpan) {
    const uint32_t* col[kCountCols];
    int64_t stride[kCountCols];
    unsigned live = 0, in_a = 0;  // bit q: column q still matching; column q is a's
#pragma unroll
    for (int q = 0; q < kCountCols; ++q) {
      const int64_t k = k0 + q * kCountThreads;
      const bool of_a = k < t1;
      col[q] = of_a ? a + k : b + (k - t1);
      stride[q] = of_a ? t1 : t2;
      live |= (k < t1 + t2 ? 1u : 0u) << q;
      in_a |= (of_a ? 1u : 0u) << q;
    }
    for (unsigned j0 = 0; j0 < n && live; j0 += kCountRows) {
      uint32_t mw[kCountRows], x[kCountRows][kCountCols];
#pragma unroll
      for (int u = 0; u < kCountRows; ++u) {
        const bool in = j0 + u < n;
        const int64_t row = in ? rows[j0 + u] : 0;
        mw[u] = in ? mask[row] : 0u;
#pragma unroll
        for (int q = 0; q < kCountCols; ++q) {
          x[u][q] = in && (live >> q & 1u) ? col[q][row * stride[q]] : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kCountRows; ++u) {
#pragma unroll
        for (int q = 0; q < kCountCols; ++q) {
          if ((x[u][q] & mw[u]) != mw[u]) live &= ~(1u << q);
        }
      }
    }
    na += __popc(live & in_a);
    nb += __popc(live & ~in_a);
  }
  na = __reduce_add_sync(0xffffffffu, na);
  nb = __reduce_add_sync(0xffffffffu, nb);
  if ((threadIdx.x & 31) == 0) {
    sums[threadIdx.x / 32][0] = na;
    sums[threadIdx.x / 32][1] = nb;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long sa = 0, sb = 0;
#pragma unroll
  for (int k = 0; k < kCountThreads / 32; ++k) {
    sa += sums[k][0];
    sb += sums[k][1];
  }
  if (gridDim.x == 1) {
    count[e] = sa * sb;
    return;
  }
  scratch += 2 * e;
  if (sa | sb) atomicAdd(scratch, sa << 32 | sb);
  __threadfence();
  if (atomicAdd(scratch + 1, 1ull) == gridDim.x - 1) {  // every block of the element has added
    __threadfence();
    const unsigned long long v = atomicAdd(scratch, 0ull);
    count[e] = (v >> 32) * (v & 0xffffffffull);
  }
}

cudaError_t launch_aligned(const void* a, const void* b, void* out, int64_t batch, int64_t w,
                           int64_t t1, int64_t t2, cudaStream_t stream) {
  constexpr int kVec = 4;
  const int64_t threads = (t1 * t2 + kVec - 1) / kVec;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  for (int64_t e0 = 0; e0 < batch; e0 += kMaxGridY) {
    const int64_t n = batch - e0 < kMaxGridY ? batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    auto kernel = n > 1 ? mul_kernel<kVec, true> : mul_kernel<kVec, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(a) + e0 * w * t1,
        static_cast<const uint32_t*>(b) + e0 * w * t2,
        static_cast<uint32_t*>(out) + e0 * w * t1 * t2, w, t1, t2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kStreamB>
cudaError_t launch_ragged(const void* a, const void* b, void* out, int64_t batch, int64_t w,
                          int64_t t1, int64_t t2, cudaStream_t stream) {
  const int64_t blocks =
      kStreamB ? t1 * ((t2 + kTile - 1) / kTile) : (t1 * t2 + kTile - 1) / kTile;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  for (int64_t e0 = 0; e0 < batch; e0 += kMaxGridY) {
    const int64_t n = batch - e0 < kMaxGridY ? batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    auto kernel = n > 1 ? mul_ragged_kernel<kStreamB, true> : mul_ragged_kernel<kStreamB, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(a) + e0 * w * t1,
        static_cast<const uint32_t*>(b) + e0 * w * t2,
        static_cast<uint32_t*>(out) + e0 * w * t1 * t2, w, t1, t2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_count(const void* a, const void* b, const void* mask, void* count,
                         void* scratch, int64_t batch, int64_t w, int64_t t1, int64_t t2,
                         cudaStream_t stream) {
  const int64_t spans = (t1 + t2 + kCountSpan - 1) / kCountSpan;
  const int64_t sweeps = (spans + kCountMaxBlocks - 1) / kCountMaxBlocks;
  const int64_t blocks = (spans + sweeps - 1) / sweeps;
  if (blocks > 1) {
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, static_cast<size_t>(batch) * 2 * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return err;
  }
  for (int64_t e0 = 0; e0 < batch; e0 += kMaxGridY) {
    const int64_t n = batch - e0 < kMaxGridY ? batch - e0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    match_count_kernel<<<grid, kCountThreads, static_cast<size_t>(w) * sizeof(uint32_t),
                         stream>>>(
        static_cast<const uint32_t*>(a) + e0 * w * t1,
        static_cast<const uint32_t*>(b) + e0 * w * t2, static_cast<const uint32_t*>(mask),
        static_cast<unsigned long long*>(count) + e0,
        static_cast<unsigned long long*>(scratch) + 2 * e0, w, t1, t2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// a [batch, w, t1], b [batch, w, t2] -> out [batch, w, t1*t2]; with `mask`
// [w] non-null, also writes element e's match count into the int64 count[e]
// (any prior content) by the column-match pass, launched after the product on
// the same stream (before it, the pass left the unaligned product at 1021 x
// 16411, which re-reads b from L2, 1-2 % slower on an H100); `scratch` is
// int64 [batch, 2] of any content, zeroed here when the pass needs it.  mode: 0 =
// aligned (K1; needs t1*t2 % 4 == 0 and a 16-byte-aligned out), 1 =
// unaligned, 2 = b-streamed.  Modes 1 and 2, and the count, take t1, t2 <
// 2^32.  A product with no chunks launches nothing and leaves count as it was.  Launches ceil(batch / 65535) grids of
// the pass and as many of the product.  Returns cudaGetLastError().
extern "C" int csgn_mul(const void* a, const void* b, const void* mask, void* out,
                        void* count, void* scratch, int64_t batch, int64_t w, int64_t t1,
                        int64_t t2, int64_t mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (mode == 0 && ((t1 * t2) % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if ((mode >= 1 || mask != nullptr) && (t1 > 0xffffffffll || t2 > 0xffffffffll)) {
    return cudaErrorInvalidValue;
  }
  if (mask != nullptr && (count == nullptr || scratch == nullptr)) return cudaErrorInvalidValue;
  if (batch <= 0 || w <= 0 || t1 <= 0 || t2 <= 0) return cudaSuccess;
  cudaError_t err;
  switch (mode) {
    case 0: err = launch_aligned(a, b, out, batch, w, t1, t2, s); break;
    case 1: err = launch_ragged<false>(a, b, out, batch, w, t1, t2, s); break;
    default: err = launch_ragged<true>(a, b, out, batch, w, t1, t2, s); break;
  }
  if (err != cudaSuccess || mask == nullptr) return err;
  return launch_count(a, b, mask, count, scratch, batch, w, t1, t2, s);
}
