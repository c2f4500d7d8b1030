// K3 — ascending sort of packed (tile, triangle) pair keys, int32 or int64:
// an LSD radix sort on 8-bit digits.
//
// Replaces bibim_tpu/ops/sort_pallas.py:_bitonic_kernel (launched by
// sort_keys_vmem, via sort_pairs / sort_pairs_z). The TPU kernel runs a
// bitonic network in VMEM; here a key's digits are its order-preserving
// unsigned form (the sign bit flipped), least significant first, and every
// pass is a stable scatter, so the result is bit-equal to any ascending
// sort of the keys.
//
// Two routes, chosen from the key count alone:
//   sort_cluster  — up to 96 k keys (config 2's 16,432, config 3's 85,540):
//                 one launch of one thread-block cluster of c <= 16 blocks
//                 of 1024 threads, each block holding P/c keys in two
//                 shared-memory buffers. Every digit's histogram as the
//                 slice is loaded (shared atomics), then per remaining
//                 digit: per-warp counts, the blocks' per-bin counts added
//                 up through distributed shared memory, and a scatter walk
//                 that ranks 32 keys at a time by digit (8 ballots) and
//                 stores each key at its global position in the buffer of
//                 the block that holds it next (the last pass: in the
//                 output). Hardware cluster barriers between the steps;
//                 nothing but the input read and the output write leaves
//                 the chip.
//   sort_onesweep — otherwise (config 5, 0.3 M keys; config 4, 0.3-1.3 M):
//                 one cudaMemsetAsync zeroes the histogram, the
//                 grid-barrier word and the look-back words, then one
//                 cooperative launch (every block resident) runs
//                   1. all digits' histograms in one read of the keys;
//                   2. a grid barrier; every block reads the same
//                      histograms and skips the digits that put all P keys
//                      in one bin (no host round trip);
//                   3. per remaining digit, a stable scatter: a block
//                      takes a tile of 256 threads x 16 keys, each warp 512
//                      contiguous keys, ranks them by digit with ballots
//                      and per-warp counters, and finds the keys of each
//                      digit in the preceding tiles by a decoupled
//                      look-back (tile t publishes its count, then adds
//                      its predecessors' counts, 16 read at once, until one
//                      has published its inclusive prefix); the tile is
//                      staged in digit order in shared memory and written
//                      out in runs; a grid barrier between digits.
//                 The number of passes decides the first destination, so
//                 the last pass lands in the output. Two launches.
// A digit that puts all P keys in one bin is skipped on both routes.
//
// What bounds it on an H100: bytes in principle, the keys read once and
// written once (the many-block route moves (1 + 2·passes)·P·size, within
// the 50 MB L2 at binning sizes). At 10^4-10^6 keys latency and issue
// rate set the pace instead: the launches, the barriers between passes,
// the look-back chain, and the per-warp ranking (8 ballots a key and
// digit). One cluster saves a launch, the memset and the grid barriers,
// but issues all the ranking on 16 SMs: past CL_ROUTE_KEYS keys the
// many-block route's 132 SMs win.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace bb {

constexpr int RADIX = 256;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Radix;
template <> struct Radix<int32_t> {
  using U = uint32_t;
  static constexpr int DIGITS = 4;
};
template <> struct Radix<long long> {
  using U = unsigned long long;
  static constexpr int DIGITS = 8;
};

template <typename T>
__device__ __forceinline__ unsigned digit_of(T key, int d) {
  using U = typename Radix<T>::U;
  const U u = (U)key ^ ((U)1 << (sizeof(U) * 8 - 1));
  return (unsigned)(u >> (8 * d)) & (RADIX - 1);
}

// The lanes of `lanes` (the warp's lanes that hold a key) whose digit
// equals this lane's: one ballot per bit.
__device__ __forceinline__ unsigned match_digit(unsigned dig, unsigned lanes) {
  unsigned peers = lanes;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned set = __ballot_sync(FULL, (dig >> b) & 1u);
    peers &= ((dig >> b) & 1u) ? set : ~set;
  }
  return peers;
}

// Exclusive scan of v over threads 0..255; every thread of the block
// calls it (threads >= 256 pass 0). wsum: 8 words of shared memory.
__device__ __forceinline__ unsigned scan256(unsigned v, unsigned* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (w < 8 && lane == 31) wsum[w] = x;
  __syncthreads();
  unsigned off = 0;
  if (w < 8)
    for (int k = 0; k < w; ++k) off += wsum[k];
  __syncthreads();
  return off + x - v;
}

// ---------------------------------------------------------------------------
// One cluster: up to 16 blocks, each holding a contiguous slice of the keys
// in its shared memory; they add up their counts and move the keys
// through distributed shared memory and meet at hardware cluster barriers.
// ---------------------------------------------------------------------------

constexpr int CL_THREADS = 1024;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int CL_MAX = 16;           // H100's largest (non-portable) cluster
constexpr int CL_BLOCK_KEYS = 512;   // keys per block the route aims for
// The most keys the route takes: past them one cluster's 16 SMs take
// longer to rank the keys than the many-block route (measured by
// chip_smoke.py: ms_by_route).
constexpr int CL_ROUTE_KEYS = 98304;

// Block r of a c-block cluster holds keys [r·per, r·per + per) of the
// current order in `cur` (dynamic shared memory, two buffers of `per`
// keys): warp w owns contiguous steps of 32 keys, so input order is
// (block, warp, step, lane) and every pass is stable. All digits'
// histograms first, as the slice is loaded (the skipped digits and the
// pass count), then per remaining digit a count walk, the blocks' per-bin
// counts added up through distributed shared memory, and a scatter walk
// that stores each key at its global position: in the `nxt` buffer of the
// block that holds that position, or in `out` on the last pass.
template <typename T>
__global__ void __launch_bounds__(CL_THREADS)
sort_cluster(const T* __restrict__ in, T* __restrict__ out, int n) {
  constexpr int D = Radix<T>::DIGITS;
  extern __shared__ __align__(16) unsigned char cl_keys[];
  __shared__ unsigned cnt[CL_WARPS * RADIX];  // histograms, then [warp][bin]
  __shared__ unsigned ctot[RADIX];            // this block's keys per bin
  __shared__ unsigned base[RADIX];            // its first position per bin
  __shared__ unsigned misc[16];               // scan scratch, skip mask
  cg::cluster_group cl = cg::this_cluster();
  const int csize = (int)cl.num_blocks();
  const int r = (int)cl.block_rank();
  const int per = (n + csize - 1) / csize;
  const int lo = min(n, r * per);
  const int m = min(n, lo + per) - lo;  // keys this block holds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int steps = (m + 31) / 32;
  const int wsteps = (steps + CL_WARPS - 1) / CL_WARPS;
  const int s0 = min(steps, warp * wsteps), s1 = min(steps, s0 + wsteps);
  T* cur = reinterpret_cast<T*>(cl_keys);
  T* nxt = cur + per;
  const float inv_per = 1.f / (float)per;

  for (int i = threadIdx.x; i < D * RADIX; i += blockDim.x) cnt[i] = 0;
  if (threadIdx.x == 0) misc[8] = 0;
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T key = in[lo + i];
    cur[i] = key;
#pragma unroll
    for (int d = 0; d < D; ++d)
      atomicAdd(&cnt[d * RADIX + digit_of(key, d)], 1u);
  }
  cl.sync();
  if (threadIdx.x < RADIX) {
    for (int d = 0; d < D; ++d) {
      unsigned total = 0;
      for (int o = 0; o < csize; ++o)
        total += cl.map_shared_rank(cnt, o)[d * RADIX + threadIdx.x];
      if (total == (unsigned)n) atomicOr(&misc[8], 1u << d);
    }
  }
  cl.sync();  // every block has read the histograms before cnt is reused
  const unsigned skip = misc[8];
  const int passes = D - __popc(skip);
  if (passes == 0) {  // every key equal
    for (int i = threadIdx.x; i < m; i += blockDim.x) out[lo + i] = cur[i];
    return;
  }

  int j = 0;
  for (int d = 0; d < D; ++d) {
    if ((skip >> d) & 1u) continue;
    const bool last = j == passes - 1;
    for (int i = threadIdx.x; i < CL_WARPS * RADIX; i += blockDim.x)
      cnt[i] = 0;
    __syncthreads();
    for (int s = s0; s < s1; ++s) {
      const int i = s * 32 + lane;
      if (i < m) atomicAdd(&cnt[warp * RADIX + digit_of(cur[i], d)], 1u);
    }
    __syncthreads();
    if (threadIdx.x < RADIX) {
      unsigned tot = 0;
      for (int w = 0; w < CL_WARPS; ++w) {
        const unsigned c = cnt[w * RADIX + threadIdx.x];
        cnt[w * RADIX + threadIdx.x] = tot;
        tot += c;
      }
      ctot[threadIdx.x] = tot;
    }
    cl.sync();  // every block's counts are in place
    unsigned total = 0, before = 0;
    if (threadIdx.x < RADIX) {
      for (int o = 0; o < csize; ++o) {
        const unsigned c = cl.map_shared_rank(ctot, o)[threadIdx.x];
        total += c;
        if (o < r) before += c;
      }
    }
    const unsigned excl = scan256(total, misc);
    if (threadIdx.x < RADIX) base[threadIdx.x] = excl + before;
    __syncthreads();
    for (int s = s0; s < s1; ++s) {
      const int i = s * 32 + lane;
      const bool live = i < m;
      const unsigned lanes =
          s * 32 + 32 <= m ? FULL : __ballot_sync(FULL, live);
      const T key = live ? cur[i] : T(0);
      const unsigned dig = digit_of(key, d);
      const unsigned peers = match_digit(dig, lanes);
      const unsigned rank = __popc(peers & lt);
      if (live) {
        const int pos = (int)(base[dig] + cnt[warp * RADIX + dig] + rank);
        if (last) {
          out[pos] = key;
        } else {
          // pos / per, from a float estimate off by at most one
          int dst = (int)((float)pos * inv_per);
          dst -= dst * per > pos;
          dst += (dst + 1) * per <= pos;
          cl.map_shared_rank(nxt, dst)[pos - dst * per] = key;
        }
      }
      __syncwarp();
      if (live && rank == 0) cnt[warp * RADIX + dig] += __popc(peers);
      __syncwarp();
    }
    // The keys have landed (visible to the cluster) and every block has
    // read the counts before any block reuses them.
    cl.sync();
    T* const t = cur;
    cur = nxt;
    nxt = t;
    ++j;
  }
}

// ---------------------------------------------------------------------------
// Many blocks: histograms, then one stable scatter per non-constant digit.
// ---------------------------------------------------------------------------

constexpr int BIG_THREADS = 256;
constexpr int BIG_WARPS = BIG_THREADS / 32;
constexpr int KPT = 16;                       // keys per thread
constexpr int TILE = BIG_THREADS * KPT;       // keys per tile
constexpr int WARP_KEYS = 32 * KPT;           // contiguous keys per warp
constexpr unsigned LB_AGG = 1u << 30;         // look-back: tile count only
constexpr unsigned LB_INC = 2u << 30;         // look-back: inclusive prefix
constexpr unsigned LB_VAL = (1u << 30) - 1u;
constexpr int LB_BATCH = 16;                  // look-back words per read
// Scratch words: histograms [DIGITS][RADIX], the barrier counter (padded
// to 32 words), then the look-back words [DIGITS][tiles][RADIX].
constexpr int SCRATCH_HDR_PAD = 32;

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The k-th grid barrier of a cooperative launch: the counter starts at 0
// and reaches k·gridDim.x when every block has arrived.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = k * gridDim.x;
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(BIG_THREADS, sizeof(T) == 4 ? 3 : 2)
sort_onesweep(const T* __restrict__ in, T* out, T* tmp, int n, int tiles,
              unsigned* scratch) {
  constexpr int D = Radix<T>::DIGITS;
  __shared__ unsigned cnt[BIG_WARPS * RADIX];  // histograms, then [warp][bin]
  __shared__ unsigned tstart[RADIX];           // a bin's first key in the tile
  __shared__ unsigned tbase[RADIX];            // its output position - tstart
  __shared__ T staged[TILE];                   // the tile in digit order
  __shared__ unsigned misc[16];                // scan scratch, skip mask
  unsigned* hist = scratch;
  unsigned* bar = scratch + D * RADIX;
  unsigned* status = bar + SCRATCH_HDR_PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;

  // 1. Every digit's histogram in one read of the keys.
  for (int i = threadIdx.x; i < D * RADIX; i += blockDim.x) cnt[i] = 0;
  if (threadIdx.x == 0) misc[8] = 0;
  __syncthreads();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int first = t * TILE + threadIdx.x;
    T key[KPT];
#pragma unroll
    for (int s = 0; s < KPT; ++s) {  // every load in flight at once
      const int i = first + s * BIG_THREADS;
      key[s] = i < n ? in[i] : T(0);
    }
#pragma unroll
    for (int s = 0; s < KPT; ++s) {
      const bool live = first + s * BIG_THREADS < n;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (live) atomicAdd(&cnt[d * RADIX + digit_of(key[s], d)], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * RADIX; i += blockDim.x)
    if (cnt[i]) atomicAdd(&hist[i], cnt[i]);
  unsigned barriers = 1;
  grid_barrier(bar, barriers);

  // 2. The digits that put every key in one bin are skipped.
  for (int d = 0; d < D; ++d)
    if (__ldcg(&hist[d * RADIX + threadIdx.x]) == (unsigned)n)
      atomicOr(&misc[8], 1u << d);
  __syncthreads();
  const unsigned skip = misc[8];
  const int passes = D - __popc(skip);
  if (passes == 0) {  // every key equal
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
      out[i] = in[i];
    return;
  }

  // 3. One stable scatter per remaining digit.
  const T* src = in;
  int j = 0;
  for (int d = 0; d < D; ++d) {
    if ((skip >> d) & 1u) continue;
    T* dst = ((passes - 1 - j) & 1) ? tmp : out;
    const unsigned gbase =
        scan256(__ldcg(&hist[d * RADIX + threadIdx.x]), misc);
    unsigned* lb = status + (size_t)j * tiles * RADIX;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int first = t * TILE + warp * WARP_KEYS + lane;
      T key[KPT];
      unsigned loc[KPT];
#pragma unroll
      for (int s = 0; s < KPT; ++s) {
        const int i = first + s * 32;
        key[s] = i < n ? __ldcg(src + i) : T(0);
      }
      for (int i = threadIdx.x; i < BIG_WARPS * RADIX; i += blockDim.x)
        cnt[i] = 0;
      __syncthreads();
#pragma unroll
      for (int s = 0; s < KPT; ++s) {
        const bool live = first + s * 32 < n;
        const unsigned lanes = first - lane + s * 32 + 32 <= n
                                   ? FULL
                                   : __ballot_sync(FULL, live);
        const unsigned dig = digit_of(key[s], d);
        const unsigned peers = match_digit(dig, lanes);
        const unsigned rank = __popc(peers & lt);
        loc[s] = live ? cnt[warp * RADIX + dig] + rank : 0u;
        __syncwarp();
        if (live && rank == 0) cnt[warp * RADIX + dig] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      // Thread = bin: warp offsets within the tile, then the look-back.
      const int bin = threadIdx.x;
      unsigned agg = 0;
      for (int w = 0; w < BIG_WARPS; ++w) {
        const unsigned c = cnt[w * RADIX + bin];
        cnt[w * RADIX + bin] = agg;
        agg += c;
      }
      unsigned* mine = lb + (size_t)t * RADIX + bin;
      unsigned prefix = 0;
      if (t == 0) {
        st_relaxed(mine, LB_INC | agg);
      } else {
        st_relaxed(mine, LB_AGG | agg);
        // LB_BATCH predecessors' words are read at once (one L2 round
        // trip), then summed nearest first up to the first inclusive one.
        bool done = false;
        for (int k = t - 1; k >= 0 && !done; k -= LB_BATCH) {
          unsigned v[LB_BATCH];
#pragma unroll
          for (int q = 0; q < LB_BATCH; ++q)
            v[q] = k - q >= 0 ? ld_relaxed(lb + (size_t)(k - q) * RADIX + bin)
                              : 0u;
#pragma unroll
          for (int q = 0; q < LB_BATCH; ++q) {
            if (!done && k - q >= 0) {
              unsigned w = v[q];
              while ((w & ~LB_VAL) == 0u)
                w = ld_relaxed(lb + (size_t)(k - q) * RADIX + bin);
              prefix += w & LB_VAL;
              done = (w & LB_INC) != 0u;
            }
          }
        }
        st_relaxed(mine, LB_INC | (prefix + agg));
      }
      // The tile's keys in digit order in shared memory, then written
      // out in runs: a bin's keys land at consecutive addresses.
      const unsigned local = scan256(agg, misc);
      tstart[bin] = local;
      tbase[bin] = gbase + prefix - local;
      __syncthreads();
#pragma unroll
      for (int s = 0; s < KPT; ++s) {
        if (first + s * 32 < n) {
          const unsigned dig = digit_of(key[s], d);
          staged[tstart[dig] + cnt[warp * RADIX + dig] + loc[s]] = key[s];
        }
      }
      __syncthreads();
      const int tn = min(TILE, n - t * TILE);
      for (int i = threadIdx.x; i < tn; i += BIG_THREADS) {
        const T k = staged[i];
        dst[tbase[digit_of(k, d)] + (unsigned)i] = k;
      }
      __syncthreads();
    }
    src = dst;
    ++j;
    if (j < passes) grid_barrier(bar, ++barriers);
  }
}

// Per-device launch facts, looked up once.
struct SortDevice {
  int sms = 0;
  int blocks[2] = {0, 0};    // resident many-block blocks per SM (i32, i64)
  int clusters[2] = {0, 0};  // largest launchable cluster (i32, i64)
  int cl_keys[2] = {0, 0};   // keys a cluster block holds (i32, i64)
};

SortDevice* sort_device() {
  static SortDevice devs[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return nullptr;
  return &devs[dev];
}

// The largest cluster of sort_cluster<T> this device can launch with the
// most dynamic shared memory a block can take (attributes set and
// sd.cl_keys found on first use); -1 when the device refuses.
template <typename T>
int max_cluster(SortDevice& sd) {
  int& c = sd.clusters[sizeof(T) == 8];
  if (c) return c;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, sort_cluster<T>) != cudaSuccess)
    return -1;
  const int dyn = (optin - (int)fa.sharedSizeBytes) / (2 * (int)sizeof(T)) *
                  (2 * (int)sizeof(T));
  if (dyn <= 0 ||
      cudaFuncSetAttribute(sort_cluster<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn) != cudaSuccess ||
      cudaFuncSetAttribute(sort_cluster<T>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return -1;
  sd.cl_keys[sizeof(T) == 8] = dyn / (2 * (int)sizeof(T));
  int top = 1;
  for (int k = 2; k <= CL_MAX; k *= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(k);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = dyn;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, sort_cluster<T>, &cfg) !=
            cudaSuccess ||
        active < 1) {
      cudaGetLastError();  // a refused size is not an error of this sort
      break;
    }
    top = k;
  }
  c = top;
  return c;
}

// The cluster size that sorts n keys in one launch: the fewest blocks
// that hold CL_BLOCK_KEYS keys each, at most the largest launchable
// cluster; 0: the many-block route (more than CL_ROUTE_KEYS keys, or more
// than that cluster's shared memory holds); -1: the device refused the
// attributes.
template <typename T>
int cluster_for(SortDevice& sd, int n) {
  if (n > CL_ROUTE_KEYS) return 0;
  const int top = max_cluster<T>(sd);
  if (top < 0) return -1;
  int c = 1;
  while (c < top && (long long)c * CL_BLOCK_KEYS < n) c *= 2;
  return (n + c - 1) / c <= sd.cl_keys[sizeof(T) == 8] ? c : 0;
}

// The route that sorts n keys: `route` < 0 picks it (cluster_for), 0 is
// the many-block route, c > 0 one cluster of c blocks (a power of two the
// device launches, holding the keys). -1: the device cannot be queried,
// -2: the route cannot sort n keys.
template <typename T>
int route_for(SortDevice& sd, int n, int route) {
  if (route < 0) return cluster_for<T>(sd, n);
  if (route == 0) return 0;
  const int top = max_cluster<T>(sd);
  if (top < 0) return -1;
  if (route > top || (route & (route - 1)) ||
      (long long)route * sd.cl_keys[sizeof(T) == 8] < n)
    return -2;
  return route;
}

template <typename T>
int sort_keys(const T* in, T* out, T* tmp, int n, unsigned* scratch,
              int route, int* launches, cudaStream_t st) {
  *launches = 0;
  SortDevice* sdp = sort_device();
  if (sdp == nullptr || n < 0 || n >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  SortDevice& sd = *sdp;
  if (n == 0) return 0;
  const int c = route_for<T>(sd, n, route);
  if (c < 0) return (int)cudaErrorInvalidConfiguration;
  if (c > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = 2 * (size_t)((n + c - 1) / c) * sizeof(T);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, sort_cluster<T>, in, out, n);
    *launches = 1;
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  if (sd.sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sd.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return (int)e;
  }
  int& per_sm = sd.blocks[sizeof(T) == 8];
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sort_onesweep<T>, BIG_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  constexpr int D = Radix<T>::DIGITS;
  int tiles = (n + TILE - 1) / TILE;
  const size_t words =
      (size_t)D * RADIX + SCRATCH_HDR_PAD + (size_t)D * tiles * RADIX;
  cudaError_t e = cudaMemsetAsync(scratch, 0, words * 4, st);
  if (e != cudaSuccess) return (int)e;
  const int grid = tiles < sd.sms * per_sm ? tiles : sd.sms * per_sm;
  void* args[] = {(void*)&in, (void*)&out, (void*)&tmp, (void*)&n,
                  (void*)&tiles, (void*)&scratch};
  e = cudaLaunchCooperativeKernel((const void*)sort_onesweep<T>, dim3(grid),
                                  dim3(BIG_THREADS), args, 0, st);
  *launches = 2;
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace bb

// Bytes of device workspace the sort of n keys of `key_bytes` on `route`
// (as route_for takes it) needs on the current device: 0 on a one-cluster
// route, else the second key buffer and the scratch words; -1 when the
// device cannot be queried or the route cannot sort n keys.
extern "C" long long bb_sort_work_bytes(int n, int key_bytes, int route) {
  bb::SortDevice* sd = bb::sort_device();
  if (sd == nullptr) return -1;
  const int c = key_bytes == 8 ? bb::route_for<long long>(*sd, n, route)
                               : bb::route_for<int32_t>(*sd, n, route);
  if (c != 0) return c < 0 ? -1 : 0;
  const long long d = key_bytes == 8 ? 8 : 4;
  const long long tiles = (n + bb::TILE - 1) / bb::TILE;
  return (long long)n * key_bytes +
         4 * (d * bb::RADIX + bb::SCRATCH_HDR_PAD + d * tiles * bb::RADIX);
}

// The cluster size that sorts n keys of `key_bytes` in one launch on the
// current device (1 = one block), 0 for the many-block route.
extern "C" int bb_sort_cluster(int n, int key_bytes) {
  bb::SortDevice* sd = bb::sort_device();
  if (sd == nullptr) return -1;
  return key_bytes == 8 ? bb::cluster_for<long long>(*sd, n)
                        : bb::cluster_for<int32_t>(*sd, n);
}

extern "C" int bb_sort_i32(const void* in, void* out, void* tmp, int n,
                           void* scratch, int route, int* launches,
                           void* stream) {
  return bb::sort_keys<int32_t>((const int32_t*)in, (int32_t*)out,
                                (int32_t*)tmp, n, (unsigned*)scratch, route,
                                launches, (cudaStream_t)stream);
}

extern "C" int bb_sort_i64(const void* in, void* out, void* tmp, int n,
                           void* scratch, int route, int* launches,
                           void* stream) {
  return bb::sort_keys<long long>((const long long*)in, (long long*)out,
                                  (long long*)tmp, n, (unsigned*)scratch,
                                  route, launches, (cudaStream_t)stream);
}
