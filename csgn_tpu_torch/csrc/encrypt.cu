// Batched encrypt on three counter-based engines, and the raw stream dump.
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
//   * K14, the JAX package's default engine (threefry2x32-20 under
//     jax.random's partitionable layout).  Replaces csgn_tpu/ops/core.py:
//     encrypt_bits, which XLA compiles under jax.jit (no Pallas kernel),
//     bit-exactly.  From the key's words, host-side: (k_words, k_rbit,
//     k_ridx) = split(key, 3) and (k_a, k_b) = split(k_ridx).  For global
//     column j of an encrypt of `total` columns, word row r is
//     (y0 ^ y1) of threefry2x32(k_words, ctr = (x >> 32, x & M)) at the
//     64-bit flat index x = r * total + j (jax.random.bits(k_words,
//     (W, total))); the broken secret index is jax.random.randint's
//     ((hb % d) * mult + lb % d) % d in uint32 arithmetic, mult =
//     (2^16 % d)^2 % d, from hb and lb, the draws of k_a and k_b at index
//     j; the coin is bit 0 of k_rbit's draw at j.  W + 3 threefry calls a
//     column.
//   * K13, the Philox stream dump: every row of the stream raw (replaces the
//     clone kernel of tools/enc_stats.py:49, which imitated K7's draws by
//     hand; here it consumes them by construction).
//
// The engines derive the words with one fix-up, as _encrypt_derive
// (encrypt_pallas.py:193-214) does it: rows [0, W) are the chunk words
// (& valid mask), the generator's `select` gives the broken secret index r
// (K4 and K7: r = row[W] % d, unsigned, and row W + 1 gives the bit-0 coin;
// K14: randint and its own coin draw);
//   bit 1: out = words | mask
//   bit 0: the word holding secret position key[r] has that bit cleared, then
//          set to the coin unless every other secret bit is already 1.
//
// Bound on the H100: K4 by its integer work (about 23 threefry calls of some
// 70 operations per column at W = 40) more than by the W*4 bytes it writes
// per column; K7 by the W*4 bytes it writes (11 Philox calls a column at
// W = 40, each round two IMAD.WIDE.U32 and two LOP3 in the SASS, take about
// 0.8 of the write time on their own); K13 by the R*4 bytes it writes;
// K14 by its integer work, as K4 (W + 3 threefry calls a column).
//
// K4, K14 and K7's column path: one thread per column, at global column
// j = col0 + its index (col0 is the first column of a rank's slice of a
// batch-sharded encrypt), `encrypt_column` templated on the generator.  The
// generator's `select` runs first, so r and the coin are known before the
// words are; every word is stored to global memory as it is
// generated (4 bytes a lane, coalesced across the warp, row by row), the
// word holding key[r] last, once the "other secret bits all one" test is
// known.
//
// K7's tile path (W <= kTileMaxWords), the one the port's widths take: a
// block of kTileCols threads owns kTileCols consecutive columns.
//   * Each thread generates its column as above, rows W and W + 1 first, and
//     stores the rows raw into a shared tile [W][kTileCols], one row after
//     another (a warp's 32 stores hit 32 banks): a row costs one shared
//     store and no fix-up work;
//   * the valid mask is applied to the rows from the first whose valid word
//     is not all ones (at most two rows of a Context);
//   * the fix-up is branch-free and runs over the nonzero mask rows only (at
//     most d of W, compacted once a block): the "other secret bits" test
//     and the bit-1 OR are two LOP3 a row.  A bit-0 column holds key[r]'s
//     bit set in its tile word during the test, which leaves that bit out of
//     it, then writes the broken word there: no 4-byte scatter reaches
//     global memory;
//   * after a barrier, the block writes each row of the tile as
//     kTileCols * 4 contiguous bytes with streaming stores: 16-byte vector
//     stores (st.global.cs.v4, as K5) when every row is 16-byte aligned
//     (batch % 4 == 0), else 4-byte stores, a form the wrapper picks per
//     launch and counts;
//   * about ten blocks are resident on an SM (the tile's W * 4 bytes a
//     column bound them), so one block's stores overlap the others'
//     generation.  Past kTileMaxWords too few blocks fit an SM, and the
//     column path serves.
// The key schedule stays in registers (the seed halves are kernel
// arguments; Philox's key bumps are constants); the secret position comes
// from a device table of key indices, not from the static unroll over d
// that Mosaic needed (encrypt_pallas.py:101-109).

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
// their stream rows; `select(w, d, r, coin)` gives the broken secret index
// r in [0, d) and the bit-0 coin.  `j` is the global column, set per thread.
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
  __device__ void select(int64_t w, uint32_t d, uint32_t& r, uint32_t& coin) const {
    r = row(w) % d;
    coin = row(w + 1) & 1u;
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
  __device__ void select(int64_t w, uint32_t d, uint32_t& r, uint32_t& coin) const {
    uint32_t y[4];
    philox4x32_10(j, static_cast<uint32_t>(w / 4), 0u, 0u, k0, k1, y);
    r = pick(y, w % 4) % d;
    if ((w + 1) % 4 == 0) {  // rows W and W + 1 straddle two groups (W % 4 == 3)
      philox4x32_10(j, static_cast<uint32_t>(w / 4 + 1), 0u, 0u, k0, k1, y);
    }
    coin = pick(y, (w + 1) % 4) & 1u;
  }
};

// K14: one word a call, row c at the flat index c * total + j of
// jax.random.bits(k_words, (W, total)); randint's two draws and the coin at
// index j of their (total,) arrays (j < 2^32, so their high counter word is 0).
struct JaxThreefry {
  static constexpr int kWidth = 1;
  uint32_t kw0, kw1, kr0, kr1, ka0, ka1, kb0, kb1;
  uint64_t total;
  uint32_t j;

  __device__ static uint32_t draw(uint32_t k0, uint32_t k1, uint64_t x) {
    uint32_t y0, y1;
    threefry2x32_20(k0, k1, static_cast<uint32_t>(x >> 32), static_cast<uint32_t>(x), y0, y1);
    return y0 ^ y1;
  }
  __device__ int64_t calls(int64_t rows) const { return rows; }
  __device__ void call(int64_t c, uint32_t (&y)[1], int64_t (&at)[1]) const {
    y[0] = draw(kw0, kw1, static_cast<uint64_t>(c) * total + j);
    at[0] = c;
  }
  // jax.random.randint(k_ridx, (total,), 0, d)[j]: every product and sum
  // wraps in uint32, as in jax's _randint.
  __device__ void select(int64_t, uint32_t d, uint32_t& r, uint32_t& coin) const {
    const uint32_t hb = draw(ka0, ka1, j), lb = draw(kb0, kb1, j);
    uint32_t mult = 65536u % d;
    mult = (mult * mult) % d;
    r = ((hb % d) * mult + lb % d) % d;
    coin = draw(kr0, kr1, j) & 1u;
  }
};

// One column of the encrypt: the fix-up shared by both engines.
template <class Gen>
__device__ __forceinline__ void encrypt_column(const Gen& gen, bool one,
                                               const int32_t* __restrict__ key_idx, int64_t d,
                                               const uint32_t* sm_mask, const uint32_t* sm_valid,
                                               uint32_t* __restrict__ col, int64_t w,
                                               int64_t batch) {
  uint32_t r, coin;
  gen.select(w, static_cast<uint32_t>(d), r, coin);
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

// `gen` holds the engine's keys; each thread sets its column.
template <class Gen>
__global__ void __launch_bounds__(kThreads)
encrypt_kernel(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
               const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
               uint32_t* __restrict__ out, int64_t w, int64_t d, int64_t batch, int64_t col0,
               Gen gen) {
  extern __shared__ uint32_t sm[];  // mask [w], then valid mask [w]
  for (int64_t r = threadIdx.x; r < w; r += blockDim.x) {
    sm[r] = mask[r];
    sm[w + r] = valid[r];
  }
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  gen.j = static_cast<uint32_t>(col0 + j);
  encrypt_column(gen, (bits[j] & 1) != 0, key_idx, d, sm, sm + w, out + j, w, batch);
}

// K7's tile path.  Shared memory (dynamic): the tile [w][kCols] of words,
// then the nonzero mask rows as (row * kCols, mask word) pairs [<= w], then
// the valid mask [w].
template <int kCols>
__host__ __device__ constexpr size_t tile_smem_bytes(int64_t w) {
  return static_cast<size_t>(w) * (kCols + 3) * sizeof(uint32_t);
}

struct TileRows {
  int full;  // rows [0, full) have an all-ones valid word
  int nnz;   // nonzero mask rows
};

// Stage the mask and valid mask of a block's tile; every thread calls it,
// and a barrier must follow before `tile_column`.  Warp 0 compacts the
// nonzero mask rows and finds the first row whose valid word is not all
// ones.
template <int kCols>
__device__ __forceinline__ void tile_stage(const uint32_t* __restrict__ mask,
                                           const uint32_t* __restrict__ valid, int w,
                                           uint2* nz, uint32_t* vs, TileRows* rows) {
  const int t = threadIdx.x;
  for (int r = t; r < w; r += kCols) vs[r] = valid[r];
  if (t < 32) {
    int nnz = 0, full = w;
    for (int base = 0; base < w; base += 32) {
      const int r = base + t;
      const uint32_t m = r < w ? mask[r] : 0u;
      const uint32_t nzb = __ballot_sync(~0u, m != 0);
      const uint32_t part = __ballot_sync(~0u, r < w && valid[r] != ~0u);
      if (m != 0) nz[nnz + __popc(nzb & ((1u << t) - 1))] = make_uint2(r * kCols, m);
      nnz += __popc(nzb);
      if (full == w && part) full = base + __ffs(part) - 1;
    }
    if (t == 0) *rows = TileRows{full, nnz};
  }
}

// One thread's column of the tile (`col` = tile + its index): the stream's
// rows as they come, the valid mask on rows [full, w), then the fix-up over
// the nonzero mask rows only.  A bit-0 column carries key[r]'s bit set
// during the test, which leaves that bit out of it, and the broken word last.
template <int kCols>
__device__ __forceinline__ void tile_column(const Philox& gen, uint32_t om,
                                            const int32_t* __restrict__ key_idx, int64_t d,
                                            const uint2* nz, const uint32_t* vs, TileRows rows,
                                            int w, uint32_t* col) {
  // Rows W and W + 1 first; the group holding row W also holds the last
  // W % 4 words.
  const int ga = w / 4, la = w % 4;
  uint32_t ya[4], yb[4];
  philox4x32_10(gen.j, static_cast<uint32_t>(ga), 0u, 0u, gen.k0, gen.k1, ya);
  uint32_t row_w1;
  if (la == 3) {  // rows W and W + 1 straddle two groups
    philox4x32_10(gen.j, static_cast<uint32_t>(ga + 1), 0u, 0u, gen.k0, gen.k1, yb);
    row_w1 = yb[0];
  } else {
    row_w1 = Philox::pick(ya, la + 1);
  }
  const int32_t pos = key_idx[Philox::pick(ya, la) % static_cast<uint32_t>(d)];
  const int r_off = (pos >> 5) * kCols;
  const uint32_t r_bit = 1u << (31 - (pos & 31));

  for (int g = 0; g < ga; ++g) {
    uint32_t y[4];
    philox4x32_10(gen.j, static_cast<uint32_t>(g), 0u, 0u, gen.k0, gen.k1, y);
#pragma unroll
    for (int l = 0; l < 4; ++l) col[(4 * g + l) * kCols] = y[l];
  }
  for (int l = 0; l < la; ++l) col[(4 * ga + l) * kCols] = Philox::pick(ya, l);
  for (int r = rows.full; r < w; ++r) col[r * kCols] &= vs[r];

  const uint32_t held = col[r_off];
  col[r_off] = held | (r_bit & ~om);
  uint32_t bad = 0;  // the secret bits a bit-0 column has at 0, key[r]'s aside
  for (int i = 0; i < rows.nnz; ++i) {
    const uint2 e = nz[i];
    const uint32_t x = col[e.x];
    bad |= e.y & ~x;
    col[e.x] = x | (e.y & om);
  }
  if (!om) col[r_off] = (held & ~r_bit) | ((bad != 0 && (row_w1 & 1u)) ? r_bit : 0u);
}

// kCols columns a block, one thread a column; kVec16 picks the 16-byte row
// stores (batch % 4 == 0) over the 4-byte ones.
template <int kCols, bool kVec16>
__global__ void __launch_bounds__(kCols)
philox_tile_kernel(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
                   const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
                   uint32_t* __restrict__ out, int w, int64_t d, int64_t batch, int64_t col0,
                   uint32_t k0, uint32_t k1) {
  extern __shared__ uint4 sm_tile[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(sm_tile);
  uint2* nz = reinterpret_cast<uint2*>(tile + w * kCols);
  uint32_t* vs = reinterpret_cast<uint32_t*>(nz + w);
  __shared__ TileRows rows;
  tile_stage<kCols>(mask, valid, w, nz, vs, &rows);
  __syncthreads();

  const int t = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int64_t j = c0 + t;
  const uint32_t om = (j < batch && (bits[j] & 1)) ? ~0u : 0u;  // all ones for bit 1
  tile_column<kCols>(Philox{k0, k1, static_cast<uint32_t>(col0 + j)}, om, key_idx, d, nz, vs,
                     rows, w, tile + t);
  __syncthreads();

  // Each row of the tile, contiguous.
  const int64_t ncols = batch - c0 < kCols ? batch - c0 : kCols;
  uint32_t* dst = out + c0;
  if (kVec16) {
    constexpr int kQuads = kCols / 4;  // 16-byte stores a row
    const int q = t % kQuads;
    if (4 * q < ncols) {
      for (int row = t / kQuads; row < w; row += kCols / kQuads) {
        __stcs(reinterpret_cast<uint4*>(dst + row * batch) + q,
               reinterpret_cast<const uint4*>(tile + row * kCols)[q]);
      }
    }
  } else if (t < ncols) {
    for (int row = 0; row < w; ++row) __stcs(dst + row * batch + t, tile[row * kCols + t]);
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

constexpr int kTileCols = 128;
constexpr int kTileMaxWords = 192;

template <class Gen>
int launch_encrypt(const void* bits, const void* key_idx, const void* mask, const void* valid,
                   void* out, int64_t w, int64_t d, int64_t batch, int64_t col0, Gen gen,
                   void* stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || d <= 0 || col0 < 0 || col0 + batch > (int64_t{1} << 32)) {
    return cudaErrorInvalidConfiguration;
  }
  encrypt_kernel<Gen><<<static_cast<unsigned>(blocks), kThreads,
                        2 * static_cast<size_t>(w) * sizeof(uint32_t),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<const int32_t*>(key_idx),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), w, d, batch, col0, gen);
  return cudaGetLastError();
}

template <int kCols, bool kVec16>
int launch_philox_tile(const void* bits, const void* key_idx, const void* mask,
                       const void* valid, void* out, int64_t w, int64_t d, int64_t batch,
                       int64_t col0, int64_t seed_lo, int64_t seed_hi, void* stream) {
  const int64_t blocks = (batch + kCols - 1) / kCols;
  if (blocks > 0x7fffffff || d <= 0 || w < 1 || col0 < 0 ||
      col0 + batch > (int64_t{1} << 32) ||
      (kVec16 && (batch % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0))) {
    return cudaErrorInvalidConfiguration;
  }
  const size_t smem = tile_smem_bytes<kCols>(w);
  const auto kernel = philox_tile_kernel<kCols, kVec16>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<const int32_t*>(key_idx),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(valid),
      static_cast<uint32_t*>(out), static_cast<int>(w), d, batch, col0,
      static_cast<uint32_t>(seed_lo), static_cast<uint32_t>(seed_hi));
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
  return launch_encrypt(bits, key_idx, mask, valid, out, w, d, batch, col0,
                        Threefry{static_cast<uint32_t>(seed_lo), static_cast<uint32_t>(seed_hi),
                                 0u, (w + 3) / 2},
                        stream);
}

// The Philox engine, the arguments of csgn_encrypt_counter and its path:
// 0 the column path, 1 the tile path with 16-byte row stores (batch % 4 == 0
// and `out` 16-byte aligned), 2 the tile path with 4-byte row stores (the
// tile path takes w <= kTileMaxWords).
extern "C" int csgn_encrypt_philox(const void* bits, const void* key_idx, const void* mask,
                                   const void* valid, void* out, int64_t w, int64_t d,
                                   int64_t batch, int64_t col0, int64_t seed_lo,
                                   int64_t seed_hi, int64_t path, void* stream) {
  if (path != 0 && w > kTileMaxWords) return cudaErrorInvalidValue;
  switch (path) {
    case 0:
      return launch_encrypt(bits, key_idx, mask, valid, out, w, d, batch, col0,
                            Philox{static_cast<uint32_t>(seed_lo),
                                   static_cast<uint32_t>(seed_hi), 0u},
                            stream);
    case 1:
      return launch_philox_tile<kTileCols, true>(bits, key_idx, mask, valid, out, w, d, batch,
                                                 col0, seed_lo, seed_hi, stream);
    case 2:
      return launch_philox_tile<kTileCols, false>(bits, key_idx, mask, valid, out, w, d,
                                                  batch, col0, seed_lo, seed_hi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K14, JAX's default engine: the arguments of csgn_encrypt_counter up to col0,
// then `total`, the columns of the whole encrypt (col0 + batch <= total <=
// 2^32), and the uint32 words of k_words, k_rbit and randint's keys k_a and
// k_b (see the top of the file).
extern "C" int csgn_encrypt_threefry(const void* bits, const void* key_idx, const void* mask,
                                     const void* valid, void* out, int64_t w, int64_t d,
                                     int64_t batch, int64_t col0, int64_t total, int64_t kw0,
                                     int64_t kw1, int64_t kr0, int64_t kr1, int64_t ka0,
                                     int64_t ka1, int64_t kb0, int64_t kb1, void* stream) {
  if (total < col0 + batch || total > (int64_t{1} << 32)) return cudaErrorInvalidValue;
  const auto u = [](int64_t x) { return static_cast<uint32_t>(x); };
  return launch_encrypt(bits, key_idx, mask, valid, out, w, d, batch, col0,
                        JaxThreefry{u(kw0), u(kw1), u(kr0), u(kr1), u(ka0), u(ka1), u(kb0),
                                    u(kb1), static_cast<uint64_t>(total), 0u},
                        stream);
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
