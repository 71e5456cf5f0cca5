// Batched encrypt on two counter-based engines, and the raw stream dump.
//
//   * K4, the counter engine (threefry2x32-20, Random123).  Replaces
//     csgn_tpu/ops/encrypt_pallas.py:encrypt_bits_counter, bit-exactly.
//     Stream spec (encrypt_pallas.py:152-157): R = W + 2 rows rounded up to
//     even, R2 = R / 2; for pair k in [0, R2) and global column j,
//     (y0, y1) = threefry2x32(key = (seed_lo, seed_hi), ctr = (k, j)); stream
//     row k is y0 and row R2 + k is y1.
//   * K7, the Philox engine (philox4x32-10, Random123).  Replaces
//     csgn_tpu/ops/encrypt_pallas.py:encrypt_bits_pallas, whose draws come
//     from the TPU's own hardware generator and are not reproducible; the
//     invariants are the same, the bits are fixed by this spec (changing it
//     is a format break): R = W + 2 rows, G = ceil(R / 4) groups per column;
//     for group g and global column j,
//     (y0..y3) = philox4x32_10(ctr = (j, g, 0, 0), key = (seed_lo, seed_hi)),
//     and stream row 4g + l is y_l.  The words depend only on (key, seed,
//     bit, j), for any batch and any block size.
//   * K13, the Philox stream dump: the K7 kernel storing every row of the
//     stream raw (replaces the clone kernel of tools/enc_stats.py:49, which
//     imitated K7's draws by hand; here it consumes them by construction).
//
// Both engines share one fix-up, `encrypt_column`, templated on the
// generator, as _encrypt_derive (encrypt_pallas.py:193-214) does it: rows
// [0, W) are the chunk words (& valid mask), row W picks the broken secret
// index r = row[W] % d (unsigned), row W + 1 gives the bit-0 coin;
//   bit 1: out = words | mask
//   bit 0: the word holding secret position key[r] has that bit cleared, then
//          set to the coin unless every other secret bit is already 1.
//
// Bound on the H100: K4 by its integer work (about 23 threefry calls of some
// 70 operations per column at W = 40) more than by the W*4 bytes it writes
// per column; K7 does 11 Philox calls of some 60 operations (mul.hi, mul.lo
// and three-input xors) at W = 40, which puts it near the write bound; K13
// writes R*4 bytes per column.  Design:
//   * one thread per column, at global column j = col0 + its index (col0 is
//     the first column of a rank's slice of a batch-sharded encrypt, so a
//     rank's words are the one-device encrypt's columns [col0, col0 + batch));
//   * the generator call(s) holding rows W and
//     W + 1 run first, so r and the coin are known before the words are, and
//     every word is stored once as it is generated (coalesced across the
//     warp, row by row);
//   * the secret position comes from a device table of key indices, not from
//     the static unroll over d that Mosaic needed (encrypt_pallas.py:101-109);
//   * the "other secret bits all one" test is accumulated on the fly; only
//     the one word that holds key[r] is held in a register and stored last;
//   * the key schedule stays in registers (the seed halves are kernel
//     arguments; Philox's key bumps are constants).

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

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t (&y)[4]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  y[0] = c0;
  y[1] = c1;
  y[2] = c2;
  y[3] = c3;
}

// Generator interface of `encrypt_column`: kWidth rows per call; `calls(w)`
// calls cover rows [0, w); `call(c, y, at)` gives the call's values and
// their stream rows; `tail(w, a, b)` gives stream rows w and w + 1.
struct Threefry {
  static constexpr int kWidth = 2;
  uint32_t k0, k1, j;
  int64_t r2;  // (W + 2 rounded up to even) / 2

  __device__ int64_t calls(int64_t) const { return r2; }
  __device__ void call(int64_t c, uint32_t (&y)[2], int64_t (&at)[2]) const {
    threefry2x32_20(k0, k1, static_cast<uint32_t>(c), j, y[0], y[1]);
    at[0] = c;
    at[1] = c + r2;
  }
  __device__ uint32_t row(int64_t r) const {
    uint32_t y0, y1;
    const bool lo = r < r2;
    threefry2x32_20(k0, k1, static_cast<uint32_t>(lo ? r : r - r2), j, y0, y1);
    return lo ? y0 : y1;
  }
  __device__ void tail(int64_t w, uint32_t& a, uint32_t& b) const {
    a = row(w);
    b = row(w + 1);
  }
};

struct Philox {
  static constexpr int kWidth = 4;
  uint32_t k0, k1, j;

  __device__ int64_t calls(int64_t rows) const { return (rows + 3) / 4; }
  __device__ void call(int64_t g, uint32_t (&y)[4], int64_t (&at)[4]) const {
    philox4x32_10(j, static_cast<uint32_t>(g), 0u, 0u, k0, k1, y);
#pragma unroll
    for (int l = 0; l < 4; ++l) at[l] = 4 * g + l;
  }
  // y[l] by selects (a dynamic index would put y in local memory).
  __device__ static uint32_t pick(const uint32_t (&y)[4], int64_t l) {
    return l == 0 ? y[0] : l == 1 ? y[1] : l == 2 ? y[2] : y[3];
  }
  __device__ void tail(int64_t w, uint32_t& a, uint32_t& b) const {
    uint32_t y[4];
    philox4x32_10(j, static_cast<uint32_t>(w / 4), 0u, 0u, k0, k1, y);
    a = pick(y, w % 4);
    if ((w + 1) % 4 == 0) {  // rows W and W + 1 straddle two groups (W % 4 == 3)
      philox4x32_10(j, static_cast<uint32_t>(w / 4 + 1), 0u, 0u, k0, k1, y);
    }
    b = pick(y, (w + 1) % 4);
  }
};

// One column of the encrypt: the fix-up shared by both engines.
template <class Gen>
__device__ __forceinline__ void encrypt_column(const Gen& gen, bool one,
                                               const int32_t* __restrict__ key_idx, int64_t d,
                                               const uint32_t* sm_mask, const uint32_t* sm_valid,
                                               uint32_t* __restrict__ col, int64_t w,
                                               int64_t batch) {
  uint32_t row_w, row_w1;
  gen.tail(w, row_w, row_w1);
  const uint32_t r = row_w % static_cast<uint32_t>(d);
  const uint32_t coin = row_w1 & 1u;
  const int32_t pos = key_idx[r];
  const int64_t r_word = pos >> 5;
  const uint32_t r_bit = 1u << (31 - (pos & 31));

  bool others_one = true;
  uint32_t held = 0;
  const int64_t ncalls = gen.calls(w);
  for (int64_t c = 0; c < ncalls; ++c) {
    uint32_t y[Gen::kWidth];
    int64_t rows[Gen::kWidth];
    gen.call(c, y, rows);
#pragma unroll
    for (int h = 0; h < Gen::kWidth; ++h) {
      const int64_t row = rows[h];
      if (row >= w) continue;
      const uint32_t word = y[h] & sm_valid[row];
      const uint32_t m = sm_mask[row];
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

template <bool kPhilox>
__global__ void __launch_bounds__(kThreads)
encrypt_kernel(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
               const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
               uint32_t* __restrict__ out, int64_t w, int64_t d, int64_t batch, int64_t col0,
               uint32_t k0, uint32_t k1) {
  extern __shared__ uint32_t sm[];  // mask [w], then valid mask [w]
  for (int64_t r = threadIdx.x; r < w; r += blockDim.x) {
    sm[r] = mask[r];
    sm[w + r] = valid[r];
  }
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  const uint32_t cj = static_cast<uint32_t>(col0 + j);
  const bool one = (bits[j] & 1) != 0;
  if (kPhilox) {
    encrypt_column(Philox{k0, k1, cj}, one, key_idx, d, sm, sm + w, out + j, w, batch);
  } else {
    encrypt_column(Threefry{k0, k1, cj, (w + 3) / 2}, one, key_idx, d, sm, sm + w, out + j,
                   w, batch);
  }
}

// K13: every row of the Philox stream, raw.
__global__ void __launch_bounds__(kThreads)
philox_streams_kernel(uint32_t* __restrict__ out, int64_t rows, int64_t batch, uint32_t k0,
                      uint32_t k1) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  const Philox gen{k0, k1, static_cast<uint32_t>(j)};
  uint32_t* col = out + j;
  const int64_t ncalls = gen.calls(rows);
  for (int64_t g = 0; g < ncalls; ++g) {
    uint32_t y[4];
    int64_t row[4];
    gen.call(g, y, row);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      if (row[l] < rows) col[row[l] * batch] = y[l];
    }
  }
}

template <bool kPhilox>
int launch_encrypt(const void* bits, const void* key_idx, const void* mask, const void* valid,
                   void* out, int64_t w, int64_t d, int64_t batch, int64_t col0,
                   int64_t seed_lo, int64_t seed_hi, void* stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || d <= 0 || col0 < 0 || col0 + batch > (int64_t{1} << 32)) {
    return cudaErrorInvalidConfiguration;
  }
  encrypt_kernel<kPhilox><<<static_cast<unsigned>(blocks), kThreads,
                            2 * static_cast<size_t>(w) * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<const int32_t*>(key_idx),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), w, d, batch, col0, static_cast<uint32_t>(seed_lo),
      static_cast<uint32_t>(seed_hi));
  return cudaGetLastError();
}

}  // namespace

// bits int32 [batch], key_idx int32 [d], mask / valid uint32 [w] -> out [w, batch],
// the columns [col0, col0 + batch) of the stream (col0 + batch <= 2^32).
// seed_lo / seed_hi are the two 32-bit halves of the seed.  Returns
// cudaGetLastError().
extern "C" int csgn_encrypt_counter(const void* bits, const void* key_idx, const void* mask,
                                    const void* valid, void* out, int64_t w, int64_t d,
                                    int64_t batch, int64_t col0, int64_t seed_lo,
                                    int64_t seed_hi, void* stream) {
  return launch_encrypt<false>(bits, key_idx, mask, valid, out, w, d, batch, col0, seed_lo,
                               seed_hi, stream);
}

// The Philox engine, same arguments as csgn_encrypt_counter.
extern "C" int csgn_encrypt_philox(const void* bits, const void* key_idx, const void* mask,
                                   const void* valid, void* out, int64_t w, int64_t d,
                                   int64_t batch, int64_t col0, int64_t seed_lo,
                                   int64_t seed_hi, void* stream) {
  return launch_encrypt<true>(bits, key_idx, mask, valid, out, w, d, batch, col0, seed_lo,
                              seed_hi, stream);
}

// out uint32 [rows, batch]: the Philox stream's rows, raw.  Returns
// cudaGetLastError().
extern "C" int csgn_philox_streams(void* out, int64_t rows, int64_t batch, int64_t seed_lo,
                                   int64_t seed_hi, void* stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || blocks == 0) return cudaErrorInvalidConfiguration;
  philox_streams_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), rows, batch, static_cast<uint32_t>(seed_lo),
      static_cast<uint32_t>(seed_hi));
  return cudaGetLastError();
}
