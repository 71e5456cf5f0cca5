// K4: batched encrypt on the counter engine (threefry2x32-20, Random123).
//
// Replaces csgn_tpu/ops/encrypt_pallas.py:encrypt_bits_counter, bit-exactly.
// Stream spec (encrypt_pallas.py:152-157): R = W + 2 rows rounded up to even,
// R2 = R / 2; for pair k in [0, R2) and global column j,
// (y0, y1) = threefry2x32(key = (seed_lo, seed_hi), ctr = (k, j)); stream row k
// is y0 and row R2 + k is y1.  Rows [0, W) are the chunk words (& valid mask),
// row W picks the broken secret index r = row[W] % d (unsigned), row W + 1
// gives the bit-0 coin.  Fix-ups as _encrypt_derive (encrypt_pallas.py:193-214):
//   bit 1: out = words | mask
//   bit 0: the word holding secret position key[r] has that bit cleared, then
//          set to the coin unless every other secret bit is already 1.
//
// Bound on the H100: the 20-round threefry (about 21 evaluations per column
// at W = 40) more than the W*4 bytes written per column.  Design:
//   * one thread per column j; rows W and W + 1 are generated first, so r and
//     the coin are known before the words are, and every word is stored once
//     as it is generated (coalesced across the warp, row by row);
//   * the secret position comes from a device table of key indices, not from
//     the static unroll over d that Mosaic needed (encrypt_pallas.py:101-109);
//   * the "other secret bits all one" test is accumulated on the fly; only
//     the one word that holds key[r] is held in a register and stored last.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1, uint32_t c0,
                                                uint32_t c1, uint32_t& y0, uint32_t& y1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, kRot[i % 8]);
    x1 ^= x0;
    if (i % 4 == 3) {
      const int inj = i / 4 + 1;
      x0 += ks[inj % 3];
      x1 += ks[(inj + 1) % 3] + static_cast<uint32_t>(inj);
    }
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ uint32_t stream_row(int64_t row, int64_t r2, uint32_t k0,
                                               uint32_t k1, uint32_t j) {
  uint32_t y0, y1;
  const bool lo = row < r2;
  threefry2x32_20(k0, k1, static_cast<uint32_t>(lo ? row : row - r2), j, y0, y1);
  return lo ? y0 : y1;
}

__global__ void __launch_bounds__(kThreads)
encrypt_counter_kernel(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
                       const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
                       uint32_t* __restrict__ out, int64_t w, int64_t d, int64_t batch,
                       uint32_t k0, uint32_t k1) {
  extern __shared__ uint32_t sm[];  // mask [w], then valid mask [w]
  for (int64_t r = threadIdx.x; r < w; r += blockDim.x) {
    sm[r] = mask[r];
    sm[w + r] = valid[r];
  }
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  const uint32_t cj = static_cast<uint32_t>(j);
  const int64_t r2 = (w + 3) / 2;  // (W + 2 rounded up to even) / 2

  const bool one = (bits[j] & 1) != 0;
  const uint32_t r = stream_row(w, r2, k0, k1, cj) % static_cast<uint32_t>(d);
  const uint32_t coin = stream_row(w + 1, r2, k0, k1, cj) & 1u;
  const int32_t pos = key_idx[r];
  const int64_t r_word = pos >> 5;
  const uint32_t r_bit = 1u << (31 - (pos & 31));

  bool others_one = true;
  uint32_t held = 0;
  uint32_t* col = out + j;
  for (int64_t k = 0; k < r2; ++k) {
    uint32_t y[2];
    threefry2x32_20(k0, k1, static_cast<uint32_t>(k), cj, y[0], y[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = k + h * r2;
      if (row >= w) continue;
      const uint32_t word = y[h] & sm[w + row];
      const uint32_t m = sm[row];
      if (one) {
        col[row * batch] = word | m;
      } else if (row == r_word) {
        const uint32_t mwo = m & ~r_bit;
        others_one &= (word & mwo) == mwo;
        held = word;
      } else {
        others_one &= (word & m) == m;
        col[row * batch] = word;
      }
    }
  }
  if (!one) {
    const uint32_t forced = others_one ? 0u : coin;
    col[r_word * batch] = (held & ~r_bit) | (forced ? r_bit : 0u);
  }
}

}  // namespace

// bits int32 [batch], key_idx int32 [d], mask / valid uint32 [w] -> out [w, batch].
// seed_lo / seed_hi are the two 32-bit halves of the seed.  Returns
// cudaGetLastError().
extern "C" int csgn_encrypt_counter(const void* bits, const void* key_idx, const void* mask,
                                    const void* valid, void* out, int64_t w, int64_t d,
                                    int64_t batch, int64_t seed_lo, int64_t seed_hi,
                                    void* stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || d <= 0) return cudaErrorInvalidConfiguration;
  encrypt_counter_kernel<<<static_cast<unsigned>(blocks), kThreads,
                           2 * static_cast<size_t>(w) * sizeof(uint32_t),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<const int32_t*>(key_idx),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), w, d, batch, static_cast<uint32_t>(seed_lo),
      static_cast<uint32_t>(seed_hi));
  return cudaGetLastError();
}
