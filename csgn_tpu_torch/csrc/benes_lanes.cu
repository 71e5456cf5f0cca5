// K8 / K9 / K12 on the lane-group path of the Beneš kernel: networks of
// 64 < WP <= 2048 words (2048 < n <= 65536), too wide for one thread's
// registers (benes.cu's register path) but not for a group of lanes'.
//
// One chunk's column of WP words is split over a group of L = WP / K lanes
// of one warp, K = kLaneWords words a lane in `uint32_t col[K]`, so a warp
// holds G = 32 / L chunks.  Lane q of a group holds the rows q, q + L,
// q + 2L, ... (local row i is network row i * L + q).  This interleaving,
// rather than a block of K consecutive rows a lane, splits every stage's
// live-row window evenly over the lanes: at n = 20000 the first and last
// stages are live on 632 of 1024 rows, which a block layout would leave on
// 20 of 32 lanes while the others idled.  A stage of delta >= 32 exchanges
// rows r and r + R (R = delta / 32, bit R of r clear):
//
//   * R >= L: both rows are the same lane's, local rows i and i + R / L:
//     the register path's `cross_word<K, R / L>` on the lane's own words;
//   * R < L: row r + R is lane q ^ R's row at the same local index: each
//     word goes over one `__shfl_xor_sync` and one bit select, both lanes
//     reading the lower lane's mask word (the plan's mask rows are zero
//     wherever bit R is set, benes.cu).  2 log2(L) stages of a network
//     exchange so: 2 at WP = 128, 10 at 2048.
//
// In-word stages (delta < 32) are the register path's `in_word<K>` on the
// lane's words.  A stage's live window is tested per 8 local rows, a test
// that is the same on every lane (8 local rows cover rows [8gL, 8(g+1)L) of
// every lane), so no lane skips a shuffle that another takes, and the
// network runs with no barrier: the warp is the unit.
//
// Memory.  In the [W, C] word-major layout one chunk's words are C apart,
// so lanes loading their own rows would touch a sector per word.  The tile
// form's block stages its CB = (T / 32) * G chunks through a shared tile
// [WP][CB] once in and once out, each row's CB words one contiguous read or
// write; the tile's columns are XOR-swizzled per row (`tile_at`) so that the
// lanes of a warp read their column words from 32 distinct banks.  The
// plan's masks are laid out for the lanes by the host (ops/benes_kernels.py
// `lane_masks`, cached per plan): per stage [K/4][L][4], so a lane's four consecutive
// local rows are one 16-byte load, the L lanes of a group read distinct
// banks and the warp's G groups share them as a broadcast.  Up to WP = 1024
// the block stages the plan in shared memory, in the tile's place once the
// column is in registers (55 KB at WP = 512 beside 128-thread blocks; the
// 116 KB of WP = 1024 leaves one block an SM, of 512 threads, which ran
// 1.3x faster on an H100 than reading the plan through L1 in 128-thread
// blocks); the 248 KB plan of WP = 2048 is read from global memory through
// L1, each warp reading it whole for its one chunk (two chunks a lane, to
// read it half as often, ran 7 % slower: 164 registers).  K = 64 words a
// lane ran as fast as K = 32 up to WP = 256 and 18-22 % faster at 512 and
// 1024 (PERF.md).  The count (K12) ORs each lane's missed key
// bits, ORs them over the group's lanes with shuffles, and adds the warp's
// matches as the register path does.
//
// Two forms move the tiles (ops/benes_kernels.py `lanes_form` picks by
// shape; both run the same network, `lanes_network`):
//
//   * the tile form, everywhere but the ring form's shapes: one block a tile,
//     in phases (scalar loads into the swizzled tile, the plan staged in its
//     place, the network, the tile back out), 5 blocks an SM at WP = 128;
//   * the ring form, WP = 128 on rows that start on 16-byte boundaries (C %
//     4 == 0 and 16-byte aligned words: what a TMA tensor map takes): a
//     persistent grid, SMs x 5 blocks of 128 threads (91 registers, 43.7 KB
//     of shared memory: the 32 KB slot, the 11.5 KB plan of 23 stages, the
//     schedule, one mbarrier), each staging its element's plan once and
//     walking tiles of 64 chunks gridDim.x apart through its one slot.  One
//     thread moves each tile by a TMA tensor copy in and one out (the 3-D
//     map [batch, W, C], a box of 128 rows by 64 columns; rows past W and
//     columns past C arrive as zeros and are not written back), so the
//     copies take no registers and no instructions of the other threads;
//     while a block waits for its next tile, the SM's four other blocks run
//     their networks.  At 2^24 chunks, n = 4096 on an H100 (PERF.md):
//     12.04 ms in the tile form, 9.9 ms in this one; the copy alone 8.6 ms
//     there and 6.1 ms here, the network alone 9.5 ms.  Tried and slower:
//     one 256-byte bulk copy a row instead of the tensor copy (14.1 ms: the
//     copy engine's rate per request), two slots a block for prefetching
//     (2 blocks, 8 warps an SM: 20.2-21.0 ms), each lane storing its own
//     words from registers (18.2 ms, 128 registers), 256-thread blocks
//     (10.5 ms); at WP = 256 this form (3 blocks an SM) ran no faster than
//     the tile form, and WP >= 512 would need boxes past TMA's 256 rows.
//     The slot is dense, so the column reads and writes meet a 2-way bank
//     conflict, once a tile.
//
// Bound on the H100: integer operations, as in benes.cu (`network_ops`);
// the shuffles are this design's cost on top of the network's work.

#include <cuda.h>

#include "benes_network.cuh"

namespace benes {
namespace {

// Words a lane (K); must equal ops/benes_kernels.py LANE_WORDS.
constexpr int kLaneWords = 64;
constexpr int kLaneThreads = 128;
// WP = 1024: its 116 KB plan staged in shared memory leaves room for one
// block an SM, so that block is 16 warps (128 registers a thread at most).
constexpr int kStagedWideThreads = 512;

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// Word (r, k) of the tile [WP][CB]: its columns XORed with a function of the
// row's lane, so that lane (g, q) of every warp reads a distinct bank.
template <int L, int CB, int G, int kShift>
__device__ __forceinline__ int tile_at(int r, int k) {
  return r * CB + (k ^ (((r & (L - 1)) >> kShift) * G));
}

// The network on the column of a lane (q) of its chunk's group: every stage
// of the schedule `sch` (delta, live rows) under the plan's masks in the
// lane layout (`plan`, [stages][K/4][L][4]).
template <int K, int L>
__device__ __forceinline__ void lanes_network(uint32_t (&col)[K], const uint32_t* plan,
                                              const int32_t* sch, int stages, int q) {
  constexpr int WP = K * L, kLogL = log2i(L);
  for (int s = 0; s < stages; ++s) {
    const int delta = sch[2 * s];
    const int live = (sch[2 * s + 1] + L - 1) >> kLogL;  // local rows i with iL < rows
    const uint32_t* m = plan + s * WP;
    if (delta < 32) {
      in_word<K, 4 * L>(col, m + 4 * q, delta, live);
      continue;
    }
    const int rr = delta >> 5;
    if (rr < L) {
      exchange<K, 4 * L>(col, m + 4 * (q & ~rr), rr, live);
      continue;
    }
    switch (rr >> kLogL) {  // the wrapper admits only `network_deltas`
      case 1: cross_word<K, 1, 4 * L>(col, m + 4 * q, live); break;
      case 2: cross_word<K, 2, 4 * L>(col, m + 4 * q, live); break;
      case 4: cross_word<K, 4, 4 * L>(col, m + 4 * q, live); break;
      case 8: cross_word<K, 8, 4 * L>(col, m + 4 * q, live); break;
      case 16: cross_word<K, 16, 4 * L>(col, m + 4 * q, live); break;
      default: cross_word<K, 32, 4 * L>(col, m + 4 * q, live); break;
    }
  }
}

// Whether the chunk's output misses no key bit (rows [w, WP) of the key are
// staged as zeros; this path has w <= WP): each lane ORs the key bits its
// words miss, the group's lanes OR theirs together.
template <int K, int L>
__device__ __forceinline__ bool lanes_match(const uint32_t (&col)[K], const uint32_t* keys, int q) {
  uint32_t miss = 0;
#pragma unroll
  for (int i = 0; i < K; i += 4) {
    uint32_t kw[4];
    load_masks<4>(kw, keys + i * L + 4 * q);
#pragma unroll
    for (int j = 0; j < 4; ++j) miss |= kw[j] & ~col[i + j];
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1) miss |= __shfl_xor_sync(0xffffffffu, miss, off);
  return miss == 0u;
}

// The key [K/4][L][4] in shared memory (count only).
template <int WP, int L, int T>
__device__ __forceinline__ void stage_key(uint32_t* keys, const uint32_t* key, int64_t w) {
  for (int e = threadIdx.x; e < WP; e += T) {
    const int r = ((e / (4 * L)) * 4 + (e & 3)) * L + ((e >> 2) & (L - 1));
    keys[e] = r < w ? key[r] : 0u;
  }
}

// The tile form: one block a tile of CB chunks, in phases (load, network,
// store) through one shared tile.
template <int K, int L, int T, bool kCount, bool kStaged>
__global__ void __launch_bounds__(T)
benes_lanes_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ masks,
                   const int32_t* __restrict__ sched, const uint32_t* __restrict__ key,
                   uint32_t* __restrict__ out, unsigned long long* __restrict__ count,
                   int64_t w, int64_t c, int stages, int w_net, int64_t plan_stride) {
  constexpr int WP = K * L, G = 32 / L, CB = T / 32 * G;
  constexpr int kLogL = log2i(L), kLogCB = log2i(CB);
  constexpr int kShift = L > T / 32 ? kLogL - log2i(T / 32) : 0;
  const int64_t b = blockIdx.y;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * CB;
  extern __shared__ uint4 lane_smem[];  // 16-byte aligned for the mask quads
  uint32_t* tile = reinterpret_cast<uint32_t*>(lane_smem);  // [WP][CB], then the plan
  const int region = kStaged && stages * WP > WP * CB ? stages * WP : WP * CB;
  uint32_t* keys = tile + region;  // [K/4][L][4] (count only)
  int32_t* sch = reinterpret_cast<int32_t*>(keys + (kCount ? WP : 0));

  const uint32_t* xb = x + b * w * c;
#pragma unroll 8
  for (int e = threadIdx.x; e < WP * CB; e += T) {
    const int r = e >> kLogCB, k = e & (CB - 1);
    tile[tile_at<L, CB, G, kShift>(r, k)] = (r < w_net && j0 + k < c) ? xb[r * c + j0 + k] : 0u;
  }
  for (int i = threadIdx.x; i < 2 * stages; i += T) sch[i] = sched[i];
  if constexpr (kCount) stage_key<WP, L, T>(keys, key, w);
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane & (L - 1);
  const int k = (threadIdx.x >> 5) * G + (lane >> kLogL);
  const bool active = j0 + k < c;  // idle chunks run on zeros for the warp sum
  uint32_t* mine = tile + tile_at<L, CB, G, kShift>(q, k);  // row q; row q + iL is iLCB on
  uint32_t col[K];
#pragma unroll
  for (int i = 0; i < K; ++i) col[i] = mine[i * L * CB];

  const uint32_t* plan = masks + b * plan_stride;
  if constexpr (kStaged) {
    __syncthreads();  // every column is read: the plan takes the tile's place
    const uint4* src = reinterpret_cast<const uint4*>(plan);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int e = threadIdx.x; e < stages * WP / 4; e += T) dst[e] = src[e];
    __syncthreads();
    plan = tile;
  }

  lanes_network<K, L>(col, plan, sch, stages, q);
  if constexpr (kCount) {
    const bool hit = lanes_match<K, L>(col, keys, q);  // every lane takes the shuffles
    add_matches(count + b, active && q == 0 && hit);
  }

  __syncthreads();  // every warp is done with the region (the staged plan)
#pragma unroll
  for (int i = 0; i < K; ++i) mine[i * L * CB] = col[i];
  __syncthreads();
  uint32_t* ob = out + b * w * c;
#pragma unroll 8
  for (int e = threadIdx.x; e < WP * CB; e += T) {
    const int r = e >> kLogCB, k = e & (CB - 1);
    if (r < w && j0 + k < c) ob[r * c + j0 + k] = tile[tile_at<L, CB, G, kShift>(r, k)];
  }
}

template <int WP, bool kCount, bool kStaged, int T>
cudaError_t launch_lanes_mode(const Args& a) {
  constexpr int K = kLaneWords, L = WP / K, CB = T / 32 * (32 / L);
  static_assert(L >= 2 && L <= 32, "a group is 2 to 32 lanes");
  const int64_t region = kStaged && a.stages * WP > WP * CB ? a.stages * WP : WP * CB;
  const size_t smem = static_cast<size_t>(region + (kCount ? WP : 0) + 2 * a.stages) *
                      sizeof(uint32_t);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  return launch_slices(benes_lanes_kernel<K, L, T, kCount, kStaged>, a, CB, T, smem);
}

// ---------------------------------------------------------------------------
// The ring form: persistent blocks, tiles in and out by TMA tensor copies
// ---------------------------------------------------------------------------

// Blocks an SM the ring form is built for: five blocks of 128 threads, 20
// warps, hold the network's latency as the tile form's five blocks did.
constexpr int kRingBlocks = 5;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of copies to land.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The tile of the tensor map at (column j0, row 0, element b) into `dst`,
// counted on `bar`; rows and columns past the tensor's edge arrive as zeros.
__device__ __forceinline__ void tile_load(uint32_t* dst, const CUtensorMap* map, int j0, int b,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, 0, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(j0), "r"(b),
      "r"(smem_u32(bar)) : "memory");
}

// `src` to the tile at (j0, 0, b); what lies past the tensor's edge is not
// written.
__device__ __forceinline__ void tile_store(const CUtensorMap* map, int j0, int b,
                                           const uint32_t* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, 0, %2}], [%3];\n"
      "cp.async.bulk.commit_group;"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(j0), "r"(b), "r"(smem_u32(src)) : "memory");
}

// The ring form.  Each block stages element b's plan, schedule and key once,
// then walks the tiles blockIdx.x, + gridDim.x, ... of CB chunks through one
// slot [WP][CB]: wait for the tile, read the columns, run the network, write
// the columns back, and one thread sends the tile out, waits until the copy
// has read the slot and sends the next tile in.  Elements are the tensor
// maps' third coordinate, b0 + blockIdx.y.
template <int K, int L, int T, bool kCount>
__global__ void __launch_bounds__(T, kRingBlocks)
benes_lanes_kernel_ring(const __grid_constant__ CUtensorMap in_map,
                        const __grid_constant__ CUtensorMap out_map,
                        const uint32_t* __restrict__ masks, const int32_t* __restrict__ sched,
                        const uint32_t* __restrict__ key, unsigned long long* __restrict__ count,
                        int64_t w, int64_t c, int stages, int64_t plan_stride, int b0) {
  constexpr int WP = K * L, G = 32 / L, CB = T / 32 * G, kLogL = log2i(L);
  constexpr uint32_t kTileBytes = WP * CB * sizeof(uint32_t);
  const int64_t b = blockIdx.y;
  const int eb = b0 + static_cast<int>(b);
  const int64_t tiles = (c + CB - 1) / CB;
  extern __shared__ __align__(128) uint32_t ring_smem[];
  uint32_t* slot = ring_smem;           // [WP][CB], as the tensor copy lays a tile
  uint32_t* plan = slot + WP * CB;      // [stages][K/4][L][4]
  uint32_t* keys = plan + stages * WP;  // [K/4][L][4] (count only)
  int32_t* sch = reinterpret_cast<int32_t*>(keys + (kCount ? WP : 0));
  uint64_t* bar = reinterpret_cast<uint64_t*>(sch + 2 * stages);

  if (threadIdx.x == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(bar, kTileBytes);
    tile_load(slot, &in_map, static_cast<int>(blockIdx.x) * CB, eb, bar);
  }
  const uint4* src = reinterpret_cast<const uint4*>(masks + b * plan_stride);
  for (int e = threadIdx.x; e < stages * WP / 4; e += T) reinterpret_cast<uint4*>(plan)[e] = src[e];
  for (int i = threadIdx.x; i < 2 * stages; i += T) sch[i] = sched[i];
  if constexpr (kCount) stage_key<WP, L, T>(keys, key, w);
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane & (L - 1);
  const int k = (threadIdx.x >> 5) * G + (lane >> kLogL);
  uint32_t* mine = slot + q * CB + k;  // row q; row q + iL is iLCB on
  uint32_t parity = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1u) {
    bar_wait(bar, parity);
    uint32_t col[K];
#pragma unroll
    for (int i = 0; i < K; ++i) col[i] = mine[i * L * CB];
    const int64_t j0 = t * CB;
    lanes_network<K, L>(col, plan, sch, stages, q);
    if constexpr (kCount) {
      const bool hit = lanes_match<K, L>(col, keys, q);  // every lane takes the shuffles
      add_matches(count + b, j0 + k < c && q == 0 && hit);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) mine[i * L * CB] = col[i];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the tensor copy
    __syncthreads();  // the tile is back in the slot
    if (threadIdx.x == 0) {
      tile_store(&out_map, static_cast<int>(j0), eb, slot);
      const int64_t next = t + gridDim.x;
      if (next < tiles) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        bar_expect(bar, kTileBytes);
        tile_load(slot, &in_map, static_cast<int>(next * CB), eb, bar);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A map of words [batch, w, c] (c % 4 == 0, 16-byte aligned) in tiles of
// `rows` rows by `cb` columns, by libcuda's cuTensorMapEncodeTiled, looked up
// through the runtime so that the library needs no link to libcuda.
cudaError_t tile_map(CUtensorMap* map, const uint32_t* words, const Args& a, int rows, int cb) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                  cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.c), static_cast<cuuint64_t>(a.w),
                              static_cast<cuuint64_t>(a.batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.c) * 4,
                                 static_cast<cuuint64_t>(a.c * a.w) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cb), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<uint32_t*>(words),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The ring form at WP = 128: one grid per 65535 elements of about
// SMs x resident blocks along x (at least one block an element, at most one
// a tile).
template <bool kCount>
cudaError_t launch_ring(const Args& a) {
  constexpr int WP = 128, T = kLaneThreads, K = kLaneWords, L = WP / K, CB = T / 32 * (32 / L);
  if (a.wp != WP || a.c % 4 != 0 || a.c > 0x7fffffff || a.batch > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = benes_lanes_kernel_ring<K, L, T, kCount>;
  const size_t smem = static_cast<size_t>(WP * CB + a.stages * WP + (kCount ? WP : 0) +
                                          2 * a.stages) * sizeof(uint32_t) + sizeof(uint64_t);
  CUtensorMap in_map, out_map;
  cudaError_t e = tile_map(&in_map, a.x, a, WP, CB);
  if (e == cudaSuccess) e = tile_map(&out_map, a.out, a, WP, CB);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (a.c + CB - 1) / CB;
  for (int64_t e0 = 0; e0 < a.batch; e0 += kMaxGridY) {
    const int64_t n = a.batch - e0 < kMaxGridY ? a.batch - e0 : kMaxGridY;
    const int64_t share = (static_cast<int64_t>(sms) * per_sm + n - 1) / n;
    const dim3 grid(static_cast<unsigned>(share < tiles ? share : tiles), static_cast<unsigned>(n));
    kernel<<<grid, T, smem, a.stream>>>(in_map, out_map, a.masks + e0 * a.plan_stride, a.sched,
                                        a.key, a.count + (a.count ? e0 : 0), a.w, a.c,
                                        static_cast<int>(a.stages), a.plan_stride,
                                        static_cast<int>(e0));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kCount>
cudaError_t launch_lanes_wp(const Args& a) {
  switch (a.wp) {
    case 128: return launch_lanes_mode<128, kCount, true, kLaneThreads>(a);
    case 256: return launch_lanes_mode<256, kCount, true, kLaneThreads>(a);
    case 512: return launch_lanes_mode<512, kCount, true, kLaneThreads>(a);
    case 1024: return launch_lanes_mode<1024, kCount, true, kStagedWideThreads>(a);
    case 2048: return launch_lanes_mode<2048, kCount, false, kLaneThreads>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_lanes(const Args& a, bool ring) {
  if (a.w > a.wp || a.w_net != a.w) return cudaErrorInvalidValue;
  if (ring) return a.key ? launch_ring<true>(a) : launch_ring<false>(a);
  return a.key ? launch_lanes_wp<true>(a) : launch_lanes_wp<false>(a);
}

}  // namespace benes
