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
// so lanes loading their own rows would touch a sector per word.  The block
// stages its CB = (T / 32) * G chunks through a shared tile [WP][CB] once in
// and once out, each row's CB words one contiguous read or write; the tile's
// columns are XOR-swizzled per row (`tile_at`) so that the lanes of a warp
// read their column words from 32 distinct banks.  The plan's masks are
// laid out for the lanes by the host (ops/benes_kernels.py `lane_masks`,
// cached per plan): per stage [K/4][L][4], so a lane's four consecutive
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
// Bound on the H100: integer operations, as in benes.cu (`network_ops`);
// the shuffles are this design's cost on top of the network's work.

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
  if constexpr (kCount) {
    for (int e = threadIdx.x; e < WP; e += T) {
      const int r = ((e / (4 * L)) * 4 + (e & 3)) * L + ((e >> 2) & (L - 1));
      keys[e] = r < w ? key[r] : 0u;
    }
  }
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

  if constexpr (kCount) {
    // A chunk matches when its output misses no key bit (rows [w, WP) of
    // the key are staged as zeros; this path has w <= WP).
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
    add_matches(count + b, active && q == 0 && miss == 0u);
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

cudaError_t launch_lanes(const Args& a) {
  if (a.w > a.wp || a.w_net != a.w) return cudaErrorInvalidValue;
  return a.key ? launch_lanes_wp<true>(a) : launch_lanes_wp<false>(a);
}

}  // namespace benes
