// Variants of the Philox encrypt K7 that split its time (tools/k7_split.py).
// Timing only: (a) and (b) write wrong words, (d) and (e) do half the work.
// Built on its own by the tool, never into the port's library.
//
//   (a) the column path with the word holding key[r] stored in the loop
//       instead of last (no deferred 4-byte scatter);
//   (b) (a) with a branch-free fix-up: a select on the bit, one store a row;
//   (d) the tile path's generator and fix-up with no global stores (the
//       compute floor): a word reaches memory only if a runtime flag says so,
//       which it never does;
//   (e) the tile path's stores with no generator (the store floor): the tile
//       holds j ^ row;
//   (f) the tile path on a persistent grid, with streaming or plain stores;
//   (g) warp-owned tiles, the untouched rows written as they are generated.
// (c), the tile path itself, is any `philox_tile_kernel` instantiation.

#include "../csrc/encrypt.cu"

namespace {

template <bool kBranchFree>
__global__ void __launch_bounds__(kThreads)
column_variant(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
               const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
               uint32_t* __restrict__ out, int64_t w, int64_t d, int64_t batch, int64_t col0,
               uint32_t k0, uint32_t k1) {
  extern __shared__ uint32_t sm_var[];
  for (int64_t r = threadIdx.x; r < w; r += blockDim.x) {
    sm_var[r] = mask[r];
    sm_var[w + r] = valid[r];
  }
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  const Philox gen{k0, k1, static_cast<uint32_t>(col0 + j)};
  const bool one = (bits[j] & 1) != 0;
  uint32_t r, coin;
  gen.select(w, static_cast<uint32_t>(d), r, coin);
  const int32_t pos = key_idx[r];
  const int64_t r_word = pos >> 5;
  const uint32_t r_bit = 1u << (31 - (pos & 31));
  bool others_one = true;
  uint32_t* col = out + j;
  for (int64_t c = 0; c < gen.calls(w); ++c) {
    uint32_t y[4];
    int64_t rows[4];
    gen.call(c, y, rows);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int64_t row = rows[h];
      if (row >= w) continue;
      const uint32_t word = y[h] & sm_var[w + row];
      const uint32_t m = sm_var[row];
      if (kBranchFree) {
        const uint32_t mm = row == r_word ? m & ~r_bit : m;
        others_one &= one || (word & mm) == mm;
        col[row * batch] = one ? word | m : word;
      } else if (one) {
        col[row * batch] = word | m;
      } else {
        const uint32_t mm = row == r_word ? m & ~r_bit : m;
        others_one &= (word & mm) == mm;
        col[row * batch] = word;
      }
    }
  }
  if (!others_one && coin && col0 < 0) out[0] = 1;  // keeps the test; col0 >= 0
}

// (d): the tile path's staging, generator and fix-up (`tile_stage`,
// `tile_column`); `sink` is never true, so no word leaves the tile.
template <int kCols>
__global__ void __launch_bounds__(kCols)
tile_compute_only(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
                  const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
                  uint32_t* __restrict__ out, int w, int64_t d, int64_t batch, int64_t col0,
                  uint32_t k0, uint32_t k1, int sink) {
  extern __shared__ uint4 sm_cmp[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(sm_cmp);
  uint2* nz = reinterpret_cast<uint2*>(tile + w * kCols);
  uint32_t* vs = reinterpret_cast<uint32_t*>(nz + w);
  __shared__ TileRows rows;
  tile_stage<kCols>(mask, valid, w, nz, vs, &rows);
  __syncthreads();
  const int t = threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kCols + t;
  const uint32_t om = (j < batch && (bits[j] & 1)) ? ~0u : 0u;
  tile_column<kCols>(Philox{k0, k1, static_cast<uint32_t>(col0 + j)}, om, key_idx, d, nz, vs,
                     rows, w, tile + t);
  if (sink && j < batch) out[j] = tile[t];
}

// (e): the tile path's barrier and 16-byte streaming row stores of j ^ row.
template <int kCols>
__global__ void __launch_bounds__(kCols)
tile_stores_only(uint32_t* __restrict__ out, int w, int64_t batch) {
  extern __shared__ uint4 sm_st[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(sm_st);
  const int t = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols;
  for (int row = 0; row < w; ++row) {
    tile[row * kCols + t] = static_cast<uint32_t>(c0 + t) ^ static_cast<uint32_t>(row);
  }
  __syncthreads();
  const int64_t ncols = batch - c0 < kCols ? batch - c0 : kCols;
  constexpr int kQuads = kCols / 4;
  const int q = t % kQuads;
  if (4 * q < ncols) {
    for (int row = t / kQuads; row < w; row += kCols / kQuads) {
      __stcs(reinterpret_cast<uint4*>(out + c0 + row * batch) + q,
             reinterpret_cast<const uint4*>(tile + row * kCols)[q]);
    }
  }
}

// (f): the tile path on a persistent grid: each block stages the key once
// and walks tiles kCols * gridDim.x apart, so one tile's stores are in
// flight while the next one is generated.
template <int kCols, bool kStream>
__global__ void __launch_bounds__(kCols)
tile_persistent(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
                const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
                uint32_t* __restrict__ out, int w, int64_t d, int64_t batch, int64_t col0,
                uint32_t k0, uint32_t k1) {
  extern __shared__ uint4 sm_per[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(sm_per);
  uint2* nz = reinterpret_cast<uint2*>(tile + w * kCols);
  uint32_t* vs = reinterpret_cast<uint32_t*>(nz + w);
  __shared__ TileRows rows;
  tile_stage<kCols>(mask, valid, w, nz, vs, &rows);
  __syncthreads();
  const int t = threadIdx.x;
  constexpr int kQuads = kCols / 4;
  const int q = t % kQuads;
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols; c0 < batch;
       c0 += static_cast<int64_t>(gridDim.x) * kCols) {
    const int64_t j = c0 + t;
    const uint32_t om = (j < batch && (bits[j] & 1)) ? ~0u : 0u;
    tile_column<kCols>(Philox{k0, k1, static_cast<uint32_t>(col0 + j)}, om, key_idx, d, nz, vs,
                       rows, w, tile + t);
    __syncthreads();
    const int64_t ncols = batch - c0 < kCols ? batch - c0 : kCols;
    if (4 * q < ncols) {
      for (int row = t / kQuads; row < w; row += kCols / kQuads) {
        uint4* dst = reinterpret_cast<uint4*>(out + c0 + row * batch) + q;
        const uint4 x = reinterpret_cast<const uint4*>(tile + row * kCols)[q];
        if (kStream) {
          __stcs(dst, x);
        } else {
          *dst = x;
        }
      }
    }
    __syncthreads();
  }
}

// (g): warp-owned tiles: each warp writes its 32 columns' rows itself, with
// no block barrier after the staging.  Rows the fix-up never touches (no
// mask bit, no key position) leave as soon as their group of four is
// generated, four rows x 32 columns a 16-byte store a lane; the touched rows
// leave after the fix-up.
template <int kCols>
__global__ void __launch_bounds__(kCols)
warp_tiles(const int32_t* __restrict__ bits, const int32_t* __restrict__ key_idx,
           const uint32_t* __restrict__ mask, const uint32_t* __restrict__ valid,
           uint32_t* __restrict__ out, int w, int64_t d, int64_t batch, int64_t col0,
           uint32_t k0, uint32_t k1) {
  extern __shared__ uint4 sm_wt[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(sm_wt);
  uint2* nz = reinterpret_cast<uint2*>(tile + w * kCols);
  uint32_t* vs = reinterpret_cast<uint32_t*>(nz + w);
  int* held = reinterpret_cast<int*>(vs + w);          // [w] the touched rows, compacted
  uint32_t* keyrows = reinterpret_cast<uint32_t*>(held + w);  // [(w + 31) / 32] bit set
  __shared__ TileRows rows;
  __shared__ int nheld;
  const int t = threadIdx.x, lane = t & 31;
  tile_stage<kCols>(mask, valid, w, nz, vs, &rows);
  if (t < 32) {
    for (int i = lane; i < (w + 31) / 32; i += 32) keyrows[i] = 0;
    __syncwarp();
    for (int64_t k = lane; k < d; k += 32) {
      const int row = key_idx[k] >> 5;
      if (row < w) atomicOr(&keyrows[row >> 5], 1u << (row & 31));
    }
    __syncwarp();
    int n = 0;
    for (int base = 0; base < w; base += 32) {
      const int r = base + lane;
      const bool touched = r < w && (mask[r] != 0 || ((keyrows[r >> 5] >> (r & 31)) & 1));
      const uint32_t b = __ballot_sync(~0u, touched);
      if (touched) held[n + __popc(b & ((1u << lane) - 1))] = r;
      n += __popc(b);
    }
    if (lane == 0) nheld = n;
    __syncwarp();
    for (int base = 0; base < w; base += 32) {   // keyrows becomes "touched"
      const int r = base + lane;
      const bool touched = r < w && (mask[r] != 0 || ((keyrows[r >> 5] >> (r & 31)) & 1));
      const uint32_t b = __ballot_sync(~0u, touched);
      if (lane == 0) keyrows[base >> 5] = b;
    }
  }
  __syncthreads();
  const uint32_t* touched = keyrows;

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int64_t j = c0 + t;
  const int64_t cw = c0 + (t & ~31);                 // the warp's first column
  const int64_t ncw = batch - cw < 32 ? batch - cw : 32;
  const uint32_t om = (j < batch && (bits[j] & 1)) ? ~0u : 0u;
  const Philox gen{k0, k1, static_cast<uint32_t>(col0 + j)};
  uint32_t* col = tile + t;
  const uint32_t* wtile = tile + (t & ~31);
  const int sub = lane >> 3, q = lane & 7;           // this lane's row of a group, its quad
  const bool quad_live = 4 * q < ncw;

  const int ga = w / 4, la = w % 4;
  uint32_t ya[4], yb[4];
  philox4x32_10(gen.j, static_cast<uint32_t>(ga), 0u, 0u, k0, k1, ya);
  uint32_t row_w1;
  if (la == 3) {
    philox4x32_10(gen.j, static_cast<uint32_t>(ga + 1), 0u, 0u, k0, k1, yb);
    row_w1 = yb[0];
  } else {
    row_w1 = Philox::pick(ya, la + 1);
  }
  const int32_t pos = key_idx[Philox::pick(ya, la) % static_cast<uint32_t>(d)];
  const int r_off = (pos >> 5) * kCols;
  const uint32_t r_bit = 1u << (31 - (pos & 31));

  auto flush = [&](int row) {  // this lane's quad of `row`, if the row is free
    if (row < w && quad_live && !((touched[row >> 5] >> (row & 31)) & 1)) {
      uint4 x = reinterpret_cast<const uint4*>(wtile + row * kCols)[q];
      if (row >= rows.full) {
        const uint32_t v = vs[row];
        x.x &= v; x.y &= v; x.z &= v; x.w &= v;
      }
      __stcs(reinterpret_cast<uint4*>(out + cw + row * batch) + q, x);
    }
  };
  for (int g = 0; g < ga; ++g) {
    uint32_t y[4];
    philox4x32_10(gen.j, static_cast<uint32_t>(g), 0u, 0u, k0, k1, y);
#pragma unroll
    for (int l = 0; l < 4; ++l) col[(4 * g + l) * kCols] = y[l];
    __syncwarp();
    flush(4 * g + sub);
  }
  for (int l = 0; l < la; ++l) col[(4 * ga + l) * kCols] = Philox::pick(ya, l);
  __syncwarp();
  flush(4 * ga + sub);
  for (int r = rows.full; r < w; ++r) col[r * kCols] &= vs[r];

  const uint32_t hw = col[r_off];
  col[r_off] = hw | (r_bit & ~om);
  uint32_t bad = 0;
  for (int i = 0; i < rows.nnz; ++i) {
    const uint2 e = nz[i];
    const uint32_t x = col[e.x];
    bad |= e.y & ~x;
    col[e.x] = x | (e.y & om);
  }
  if (!om) col[r_off] = (hw & ~r_bit) | ((bad != 0 && (row_w1 & 1u)) ? r_bit : 0u);
  __syncwarp();
  if (quad_live) {
    for (int i = sub; i < nheld; i += 4) {
      const int row = held[i];
      __stcs(reinterpret_cast<uint4*>(out + cw + row * batch) + q,
             reinterpret_cast<const uint4*>(wtile + row * kCols)[q]);
    }
  }
}

template <class F>
int grid_launch(F launch, int64_t batch, int cols) {
  const int64_t blocks = (batch + cols - 1) / cols;
  if (blocks > 0x7fffffff || batch % 4 != 0) return cudaErrorInvalidConfiguration;
  launch(static_cast<unsigned>(blocks));
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = (a), 1 = (b), 2 = (c) at 128 columns a block, 3 = (c) at 256
// (any w: the tile path's width limit is the library entry's), 4 = (d) at
// 128, 5 = (e) at 128, 6 = (f) at 128, 7 = (c) at 64, 8 = (f) with plain
// (not streaming) stores, 9 = (g) at 128.  Arguments as csgn_encrypt_philox's; batch % 4 == 0.
extern "C" int k7_split_variant(int64_t variant, const void* bits, const void* key_idx,
                                const void* mask, const void* valid, void* out, int64_t w,
                                int64_t d, int64_t batch, int64_t col0, int64_t seed_lo,
                                int64_t seed_hi, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const int32_t*>(bits);
  const auto k = static_cast<const int32_t*>(key_idx);
  const auto m = static_cast<const uint32_t*>(mask);
  const auto v = static_cast<const uint32_t*>(valid);
  const auto o = static_cast<uint32_t*>(out);
  const auto k0 = static_cast<uint32_t>(seed_lo), k1 = static_cast<uint32_t>(seed_hi);
  const size_t pairs = 2 * static_cast<size_t>(w) * sizeof(uint32_t);
  switch (variant) {
    case 0:
      return grid_launch([&](unsigned g) {
        column_variant<false><<<g, kThreads, pairs, s>>>(b, k, m, v, o, w, d, batch, col0, k0,
                                                         k1);
      }, batch, kThreads);
    case 1:
      return grid_launch([&](unsigned g) {
        column_variant<true><<<g, kThreads, pairs, s>>>(b, k, m, v, o, w, d, batch, col0, k0,
                                                        k1);
      }, batch, kThreads);
    case 2:
      return launch_philox_tile<128, true>(bits, key_idx, mask, valid, out, w, d, batch, col0,
                                           seed_lo, seed_hi, stream);
    case 3:
      return launch_philox_tile<256, true>(bits, key_idx, mask, valid, out, w, d, batch, col0,
                                           seed_lo, seed_hi, stream);
    case 4: {
      const size_t smem = tile_smem_bytes<128>(w);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_compute_only<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
      }
      return grid_launch([&](unsigned g) {
        tile_compute_only<128><<<g, 128, smem, s>>>(b, k, m, v, o, static_cast<int>(w), d,
                                                    batch, col0, k0, k1, 0);
      }, batch, 128);
    }
    case 5: {
      const size_t smem = static_cast<size_t>(w) * 128 * sizeof(uint32_t);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_stores_only<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
      }
      return grid_launch([&](unsigned g) {
        tile_stores_only<128><<<g, 128, smem, s>>>(o, static_cast<int>(w), batch);
      }, batch, 128);
    }
    case 6:
    case 8: {
      const size_t smem = tile_smem_bytes<128>(w);
      const auto kernel = variant == 6 ? tile_persistent<128, true> : tile_persistent<128, false>;
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
      }
      int per_sm = 0, sms = 0, dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128, smem);
      const int64_t tiles = (batch + 127) / 128;
      const int64_t grid = tiles < int64_t{per_sm} * sms ? tiles : int64_t{per_sm} * sms;
      if (batch % 4 != 0 || grid < 1) return cudaErrorInvalidConfiguration;
      kernel<<<static_cast<unsigned>(grid), 128, smem, s>>>(b, k, m, v, o, static_cast<int>(w),
                                                            d, batch, col0, k0, k1);
      return cudaGetLastError();
    }
    case 7:
      return launch_philox_tile<64, true>(bits, key_idx, mask, valid, out, w, d, batch, col0,
                                          seed_lo, seed_hi, stream);
    case 9: {
      const size_t smem = tile_smem_bytes<128>(w) + (static_cast<size_t>(w) + (w + 31) / 32) * 4;
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            warp_tiles<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
      }
      return grid_launch([&](unsigned g) {
        warp_tiles<128><<<g, 128, smem, s>>>(b, k, m, v, o, static_cast<int>(w), d, batch,
                                             col0, k0, k1);
      }, batch, 128);
    }
    default:
      return cudaErrorInvalidValue;
  }
}
