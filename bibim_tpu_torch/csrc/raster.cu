// K1 — raster + resolve + perspective-correct interpolation; K10, the same
// scan over group windows; K4, the same scan over a compact list of live
// tiles, compositing flat colour into the LDR planes; K1's tail, the same
// scan over the dense tiles' candidates past the first window, merged into
// the frame's planes in place.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel (launched by
// raster_fused_pallas; tie rule in _chunk_test), as raster_gw_kernel
// _fused_kernel_gw (single-pass frames with group_pair_cap) and, as
// overlay_kernel, _overlay_kernel (launched by composite_overlay_pallas:
// the light spheres and the HUD). Slot s
// rasterizes one 8x128 screen tile from its candidate sequence: the
// overflow list, then its sorted window. Per pixel the winner is the last
// candidate whose packed depth key is >= the running key, starting from the
// initial key — that is, the lexicographic maximum of (key, candidate
// index) over the candidates and the initial key, which carries index -1.
// K1's window starts at starts[s]; K10's at win[s / group] + lb_al[s] (the
// group's window in the pair list, then the slot's 8-aligned base in it:
// the up to 7 prefix rows before its own belong to the previous tile and
// cannot cover this one, or duplicate a later row whose position wins the
// tie). Both read no row twice: the sorted list is contiguous in slot
// order, so a group's windows are consecutive runs of one window. K4's
// slot s continues the scene's keys of its tile, zkey[ids[s]] (or a
// cleared key, 0), and where an overlay triangle (_ID >= 0.5) wins a
// pixel, its interpolated vertex colour replaces that pixel of the LDR
// planes in place; no other pixel is read or written.
//
// What bounds it on an H100: operations, about 25 per candidate and pixel
// (five plane evaluations, the IEEE reciprocal, the key). One block of 256
// threads scanning a 512-candidate window alone on one SM took as long as
// a whole pass of config 4 (PERF.md): the longest window set the pace
// while the other SMs idled. So:
//   - A slot's sequence is split into `csize` contiguous parts, scanned by
//     the csize blocks of one thread-block cluster (csize in {1,2,4,8},
//     chosen by the wrapper from static capacities). Each block keeps per
//     pixel the lexicographic max of (key, index); the blocks merge it
//     through distributed shared memory and rank 0 resolves the winner's
//     record and writes the planes. Parts hold at least MIN_PART
//     candidates: a slot with fewer (an empty window of a dense pass) is
//     scanned by rank 0 alone, and the other blocks leave at once.
//   - The three edge functions come first; when no lane of the warp passes
//     them the depth planes and the reciprocal are skipped. Exact: a miss's
//     key does not depend on them.
//   - Coefficients (the record's first 16 floats: 15 coverage channels and
//     _ID) are staged 128 candidates a round with 16-byte cp.async copies,
//     double-buffered: round r+1's copies and round r+2's triangle ids are
//     in flight while round r is tested.
//   - K4 (an overlay touches 8-28 tiles of a list sized for the worst
//     frame, n_live of them live, a count the host never reads) runs on a
//     fixed grid of clusters: cluster g scans live slots g, g + G, ...,
//     so no block is launched per dead slot and the grid does not depend
//     on the list's size. Its windows are short (22-100 candidates on
//     average), so its parts hold at least OVERLAY_MIN_PART (8)
//     candidates: one SM's scan of a whole window was most of its time.
//   - The tail (TAIL mode; the TPU ran passes 1..P-1 of a window each, in
//     order, a VMEM-sized window a pass) is one launch for all of them.
//     What bounds it is the spread of its work: the densest tile's tail
//     holds ~32k candidates at config 4's yaw -45 (63 windows of 512),
//     most slots' a few windows, dead slots none. So each slot's sequence
//     is cut into parts of MIN_PART (64) candidates (a part is the
//     pace-setter: parts of 64 beat parts of a whole 512-candidate window
//     by 1.2-3.2x, PERF.md), laid end to end in one flat list (`ends`, the
//     prefix sums of the slots' part counts, made on the device), and one
//     resident wave of blocks takes the list's parts in turn from a
//     counter. The grid does not grow with the static caps: a block for
//     each part the caps allow is ~1,400 blocks a slot at the viewer's 88
//     passes of 1,024, nearly all empty. The parts' costs differ, so a
//     block striding over the list by a fixed step left some blocks long
//     behind the others (1.5x at yaw -45); taken in turn, the densest
//     tile's parts still spread over the whole card. Each part merges
//     its per-pixel winners into the slot's packed (key, index) maxima
//     with a 64-bit atomicMax (order-free, so the result does not depend
//     on which part finishes first); the slot's last part to arrive reads
//     the maxima and, only where a candidate of the tail won, writes the
//     key and the planes in place at the slot's frame tile — what the
//     chained passes computed, with no pass-by-pass scatter.
// The scan keeps the reference's arithmetic bit for bit (common.cuh):
// z = zn * __frcp_rn(wn), key bits(z) & ~7 accepted with >=, -fmad=false.
// Each pixel then reads its winner's record (60 floats, L2-resident) by
// index — the TPU's one-hot MXU resolve is not ported — and writes the
// requested planes, coalesced (consecutive threads own consecutive pixels).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace bb {

struct RasterArgs {
  const float* rec;
  int rec_stride;
  const int* big_ids;
  const int* n_big;
  int big_len;
  const int* pair_tri;
  int pair_len;
  const int* ids;
  const int* starts;
  const int* counts;
  const int* win;  // K10: the group windows' first rows, else unused
  int group;       // K10: slots per group window
  const int* init_zkey;  // K1, K10: by slot; K4: by tile, or null (0)
  int n_slots, tiles_x, tile_h, tile_w;
  unsigned mask;
  int* zkey;
  float* fields;
  const int* n_live;   // K4: slots [0, n_live) are live
  float* ldr;          // K4: three LDR planes of (·, npx), in place
  long long ldr_cstride;  // K4: floats from one LDR plane to the next
  // K1's tail: zkey and fields are the frame's planes (in place; zkey
  // also holds the initial keys), plane row = ids[s] - row_off.
  unsigned long long* best = nullptr;  // (n_slots, npx) maxima, zeroed
  int* arrived = nullptr;  // (n_slots,) parts that finished, zeroed
  int* next = nullptr;     // the next part to hand out, zeroed
  // (n_slots,) inclusive prefix sums of the slots' parts, ceil(counts[s] /
  // MIN_PART): the flat list of parts that the blocks take in turn.
  const int* ends = nullptr;
  int row_off = 0;         // frame tile id of plane row 0
  long long fstride = 0;   // floats from one field plane to the next
};

// The scan's four callers: K1, K10 (GW: group-window addressing), K4 and
// K1's tail.
enum Mode { RASTER, GW, OVERLAY, TAIL };

// K1's tail: pixel p of frame plane row `row` takes the tail's winner:
// its key and, where it is a triangle (_ID >= 0.5, the test by which the
// chained passes replaced a plane), the planes selected by `mask`, plane
// f at fields + f * fstride.
__device__ inline void merge_pixel(const float* rec, int rec_stride,
                                   int best, int key, float px, float py,
                                   unsigned mask, int row, int npx, int p,
                                   long long fstride, int* zkey,
                                   float* fields) {
  const size_t o = (size_t)row * npx + p;
  zkey[o] = key;
  float v[N_FIELDS];
  resolve_fields(best >= 0 ? rec + (size_t)best * rec_stride : nullptr, px,
                 py, v);
  if (!(v[1] >= 0.5f)) return;
  int slot = 0;
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    if ((mask >> f) & 1u) {
      fields[(size_t)slot * fstride + o] = v[f];
      ++slot;
    }
  }
}

// Scans slot s as rank `rank` of a cluster of csize blocks (the tail:
// part `rank` of the slot, csize 1). PPT: pixels per thread (tiles of up
// to PPT·THREADS pixels).
template <int PPT, Mode MODE>
__device__ __forceinline__ void raster_scan(const RasterArgs& a, int csize,
                                            int s, int rank) {
  __shared__ __align__(16) float sco[2][STAGE][STAGE_CH];
  const int nb = MODE == TAIL ? 0 : min(*a.n_big, a.big_len);
  const int start =
      MODE == GW ? a.win[s / a.group] + a.starts[s] : a.starts[s];
  const int total = nb + a.counts[s];
  int lo, hi, parts = 1;
  if constexpr (MODE == TAIL) {
    lo = min(total, rank * MIN_PART);
    hi = min(total, lo + MIN_PART);
    if (lo >= hi) return;
  } else {
    // With one part in use, rank 0 scans the whole sequence and no block
    // meets another: the others leave.
    parts = cluster_part(total, csize, rank, &lo, &hi,
                         MODE == OVERLAY ? OVERLAY_MIN_PART : MIN_PART);
    if (parts <= 1 && rank != 0) return;
  }
  const int npx = a.tile_h * a.tile_w;
  const int tid = a.ids[s];
  const int row = tid / a.tiles_x, col = tid - row * a.tiles_x;
  const int* init =
      MODE == TAIL ? a.zkey + (size_t)(tid - a.row_off) * npx
      : MODE != OVERLAY ? a.init_zkey + (size_t)s * npx
      : a.init_zkey != nullptr ? a.init_zkey + (size_t)tid * npx : nullptr;
  float px[PPT], py[PPT];
  int bkey[PPT], bidx[PPT];
  int npt = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    bidx[k] = -1;
    px[k] = py[k] = 0.f;
    bkey[k] = 0;
    if (p < npx) {
      npt = k + 1;
      px[k] = (float)(p % a.tile_w + col * a.tile_w) + 0.5f;
      py[k] = (float)(p / a.tile_w + row * a.tile_h) + 0.5f;
      if (MODE != OVERLAY || init != nullptr) bkey[k] = init[p] & LOW3;
    }
  }

  // Two threads stage each of a round's STAGE candidates, 8 floats each.
  const int cand = threadIdx.x >> 1, half = (threadIdx.x & 1) * 8;
  const int rounds = (hi - lo + STAGE - 1) / STAGE;
  auto tri_at = [&](int c) {
    return c < hi ? candidate_tri(a.big_ids, nb, a.pair_tri, a.pair_len,
                                  start, c)
                  : -1;
  };
  auto stage = [&](int buf, int tri) {
    const bool ok = tri >= 0;
    const float* src = a.rec + (ok ? (size_t)tri * a.rec_stride : 0) + half;
    cp_async16(&sco[buf][cand][half], src, ok);
    cp_async16(&sco[buf][cand][half + 4], src + 4, ok);
    cp_async_commit();
  };
  int tri_next = -1;
  if (rounds > 0) stage(0, tri_at(lo + cand));
  if (rounds > 1) tri_next = tri_at(lo + STAGE + cand);
  const int miss = __float_as_int(-1.f) & LOW3;
  for (int r = 0; r < rounds; ++r) {
    const int c0 = lo + r * STAGE;
    if (r + 1 < rounds) {
      stage((r + 1) & 1, tri_next);
      if (r + 2 < rounds) tri_next = tri_at(c0 + 2 * STAGE + cand);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(STAGE, hi - c0);
    for (int i = 0; i < n; ++i) {
      const float4* q = reinterpret_cast<const float4*>(sco[r & 1][i]);
      const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
      const float co[15] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                            q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z};
      bool in[PPT];
      bool any_in = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        in[k] = k < npt &&
                plane_eval(co[0], co[3], co[6], px[k], py[k]) >= 0.f &&
                plane_eval(co[1], co[4], co[7], px[k], py[k]) >= 0.f &&
                plane_eval(co[2], co[5], co[8], px[k], py[k]) >= 0.f;
        any_in |= in[k];
      }
      const int c = c0 + i;
      if (__any_sync(0xffffffffu, any_in)) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (k < npt) {
            int key = miss;
            if (in[k]) {
              const float zn = plane_eval(co[9], co[10], co[11], px[k],
                                          py[k]);
              const float wn = plane_eval(co[12], co[13], co[14], px[k],
                                          py[k]);
              const bool ok = wn > 0.f && zn >= 0.f && zn <= wn;
              const float z = zn * __frcp_rn(wn == 0.f ? 1.f : wn);
              key = __float_as_int(ok ? z : -1.f) & LOW3;
            }
            if (key >= bkey[k]) {
              bkey[k] = key;
              bidx[k] = c;
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (k < npt && miss >= bkey[k]) {
            bkey[k] = miss;
            bidx[k] = c;
          }
        }
      }
    }
    __syncthreads();
  }

  if (MODE != TAIL && parts > 1) {
    // Merge the parts: the staging buffers (16 KB) hold each block's
    // packed winners (at most THREADS · 8 pixels).
    cg::cluster_group cl = cg::this_cluster();
    unsigned long long* best = reinterpret_cast<unsigned long long*>(
        &sco[0][0][0]);
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      best[threadIdx.x + k * THREADS] = pack_best(bkey[k], bidx[k]);
    cl.sync();
    if (rank == 0) {
      for (int o = 1; o < parts; ++o) {
        const unsigned long long* other = cl.map_shared_rank(best, o);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const unsigned long long v = other[threadIdx.x + k * THREADS];
          if (v > pack_best(bkey[k], bidx[k])) {
            bkey[k] = best_key(v);
            bidx[k] = best_idx(v);
          }
        }
      }
    }
    cl.sync();  // the other blocks' shared memory stays until rank 0 read it
    if (rank != 0) return;
  }
  if constexpr (MODE == TAIL) {
    // This part's winners into the slot's maxima; the slot's last part to
    // arrive (after every other part's atomics, by the fences) resolves
    // them. A pixel no candidate of the tail won keeps its planes.
    unsigned long long* best = a.best + (size_t)s * npx;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (k < npt && bidx[k] >= 0)
        atomicMax(best + threadIdx.x + k * THREADS,
                  pack_best(bkey[k], bidx[k]));
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    if (threadIdx.x == 0) {
      const int n = (total + MIN_PART - 1) / MIN_PART;
      last = atomicAdd(a.arrived + s, 1) == n - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (k >= npt) continue;
      const int p = threadIdx.x + k * THREADS;
      const unsigned long long v = __ldcg(best + p);
      if (v == 0ull) continue;  // the initial key stands
      const int tri = candidate_tri(a.big_ids, 0, a.pair_tri, a.pair_len,
                                    start, best_idx(v));
      merge_pixel(a.rec, a.rec_stride, tri, best_key(v), px[k], py[k],
                  a.mask, tid - a.row_off, npx, p, a.fstride, a.zkey,
                  a.fields);
    }
  } else if constexpr (MODE == OVERLAY) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (k >= npt || bidx[k] < 0) continue;
      const int tri = candidate_tri(a.big_ids, nb, a.pair_tri, a.pair_len,
                                    start, bidx[k]);
      if (tri < 0) continue;
      const float* r = a.rec + (size_t)tri * a.rec_stride;
      if (!(r[CH_ID] >= 0.5f)) continue;
      float e[3], inv;
      bary(r, px[k], py[k], e, &inv);
      const float b0 = e[0] * inv, b1 = e[1] * inv, b2 = e[2] * inv;
      float* o = a.ldr + (size_t)tid * npx + threadIdx.x + k * THREADS;
      for (int c = 0; c < 3; ++c)
        o[c * a.ldr_cstride] = blend3(r, CH_COL + 3 * c, b0, b1, b2);
    }
  } else {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (k < npt) {
        const int tri =
            bidx[k] < 0 ? -1
                        : candidate_tri(a.big_ids, nb, a.pair_tri,
                                        a.pair_len, start, bidx[k]);
        write_pixel(a.rec, a.rec_stride, tri, bkey[k], px[k], py[k], a.mask,
                    s, a.n_slots, npx, threadIdx.x + k * THREADS, a.zkey,
                    a.fields);
      }
    }
  }
}

// K1's tail: the slot that flat part g belongs to, the first s with
// ends[s] > g (ends nondecreasing, g < ends[n - 1]). Each warp narrows the
// range 32 segments at a time, so a 2,048-slot list takes three rounds of
// loads.
__device__ __forceinline__ int tail_slot(const int* ends, int n, int g) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int end = min(lo + (lane + 1) * step, hi) - 1;
    const unsigned m = __ballot_sync(0xffffffffu, ends[end] > g);
    lo += (__ffs(m) - 1) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// K1 (RASTER: block b scans rank b % csize of slot b / csize) and its tail
// (TAIL: one resident wave of blocks taking the flat list's parts in turn
// from a counter, part g being rank g - ends[s - 1] of slot s; a block
// that finishes early takes the next part, as the block scheduler hands a
// free SM the next block).
template <int PPT, Mode MODE>
__global__ void __launch_bounds__(THREADS)
raster_kernel(const RasterArgs a, int csize) {
  if constexpr (MODE == TAIL) {
    __shared__ int taken;
    const int total = a.ends[a.n_slots - 1];
    for (;;) {
      if (threadIdx.x == 0) taken = atomicAdd(a.next, 1);
      __syncthreads();
      const int g = taken;
      if (g >= total) return;
      const int s = tail_slot(a.ends, a.n_slots, g);
      raster_scan<PPT, TAIL>(a, 1, s, g - (s > 0 ? a.ends[s - 1] : 0));
      __syncthreads();  // `taken` and the staging buffers are reused
    }
  } else {
    raster_scan<PPT, MODE>(a, csize, blockIdx.x / csize, blockIdx.x % csize);
  }
}

// The tail's grid: one resident wave of raster_kernel<PPT, TAIL> (its
// occupancy looked up once per device), whatever the list's length.
template <int PPT>
int launch_tail(const RasterArgs& a, cudaStream_t st) {
  constexpr int MAX_DEVICES = 64;
  static int wave[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& full = wave[dev % MAX_DEVICES];
  if (full == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, raster_kernel<PPT, TAIL>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    full = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  raster_kernel<PPT, TAIL><<<full, THREADS, 0, st>>>(a, 1);
  return (int)cudaGetLastError();
}

template <int PPT>
__global__ void __launch_bounds__(THREADS)
raster_gw_kernel(const RasterArgs a, int csize) {
  raster_scan<PPT, GW>(a, csize, blockIdx.x / csize, blockIdx.x % csize);
}

// K4: gridDim.x / csize clusters deal the live slots round robin; n_live
// is the same for every block, so a cluster's blocks take the same slots.
template <int PPT>
__global__ void __launch_bounds__(THREADS)
overlay_kernel(const RasterArgs a, int csize) {
  const int n_live = min(*a.n_live, a.n_slots);
  const int clusters = gridDim.x / csize;
  for (int s = blockIdx.x / csize; s < n_live; s += clusters)
    raster_scan<PPT, OVERLAY>(a, csize, s, blockIdx.x % csize);
}

// grid: the launch's blocks (K1, K10: n_slots · csize; K4: its clusters ·
// csize; the tail: unused, csize 1, see launch_tail).
template <Mode MODE>
int launch_raster(const RasterArgs& a, int csize, int grid, cudaStream_t st) {
  const int npx = a.tile_h * a.tile_w;
  if (npx <= 0 || npx > THREADS * MAX_PPT || a.rec_stride % 4 != 0 ||
      a.rec_stride < STAGE_CH ||
      (csize != 1 && csize != 2 && csize != 4 && csize != 8) ||
      grid % csize != 0 ||
      (MODE == GW && (a.group < 1 || a.n_slots % a.group != 0)) ||
      (MODE == TAIL && csize != 1))
    return (int)cudaErrorInvalidValue;
  if (a.n_slots <= 0 || grid <= 0) return (int)cudaGetLastError();
  auto go = [&](auto kernel) {
    return launch_clustered(kernel, grid, THREADS, csize, st, a, csize);
  };
  auto pick = [&](auto k1, auto k2, auto k4, auto k8) {
    if (npx <= THREADS) return go(k1);
    if (npx <= 2 * THREADS) return go(k2);
    if (npx <= 4 * THREADS) return go(k4);
    return go(k8);
  };
  if (MODE == OVERLAY)
    return pick(overlay_kernel<1>, overlay_kernel<2>, overlay_kernel<4>,
                overlay_kernel<8>);
  if (MODE == GW)
    return pick(raster_gw_kernel<1>, raster_gw_kernel<2>,
                raster_gw_kernel<4>, raster_gw_kernel<8>);
  if (MODE == TAIL) {
    if (npx <= THREADS) return launch_tail<1>(a, st);
    if (npx <= 2 * THREADS) return launch_tail<2>(a, st);
    if (npx <= 4 * THREADS) return launch_tail<4>(a, st);
    return launch_tail<8>(a, st);
  }
  return pick(raster_kernel<1, RASTER>, raster_kernel<2, RASTER>,
              raster_kernel<4, RASTER>, raster_kernel<8, RASTER>);
}

}  // namespace bb

extern "C" int bb_raster(const float* rec, const int* big_ids,
                         const int* n_big, int big_len, const int* pair_tri,
                         int pair_len, const int* ids, const int* starts,
                         const int* counts, const int* init_zkey, int n_slots,
                         int tiles_x, int tile_h, int tile_w, int rec_stride,
                         unsigned mask, int csize, int* zkey, float* fields,
                         void* stream) {
  const bb::RasterArgs a{rec,     rec_stride, big_ids,  n_big,   big_len,
                         pair_tri, pair_len,  ids,      starts,  counts,
                         nullptr, 1,          init_zkey, n_slots, tiles_x,
                         tile_h,  tile_w,     mask,     zkey,    fields};
  return bb::launch_raster<bb::RASTER>(a, csize, n_slots * csize,
                                       (cudaStream_t)stream);
}

extern "C" int bb_raster_gw(const float* rec, const int* big_ids,
                            const int* n_big, int big_len,
                            const int* pair_tri, int pair_len,
                            const int* ids, const int* win,
                            const int* lb_al, const int* cnt_k,
                            const int* init_zkey, int n_slots, int group,
                            int tiles_x, int tile_h, int tile_w,
                            int rec_stride, unsigned mask, int csize,
                            int* zkey, float* fields, void* stream) {
  const bb::RasterArgs a{rec,     rec_stride, big_ids,  n_big,   big_len,
                         pair_tri, pair_len,  ids,      lb_al,   cnt_k,
                         win,     group,      init_zkey, n_slots, tiles_x,
                         tile_h,  tile_w,     mask,     zkey,    fields};
  return bb::launch_raster<bb::GW>(a, csize, n_slots * csize,
                                   (cudaStream_t)stream);
}

// K4: slots [0, *n_live) of the n_slots-long compact list, on `clusters`
// clusters of csize blocks; zkey (the scene's keys by tile) may be null.
extern "C" int bb_overlay(const float* rec, const int* big_ids,
                          const int* n_big, int big_len, const int* pair_tri,
                          int pair_len, const int* ids, const int* starts,
                          const int* counts, const int* n_live,
                          const int* zkey, float* ldr, long long ldr_cstride,
                          int n_slots, int tiles_x, int tile_h, int tile_w,
                          int rec_stride, int csize, int clusters,
                          void* stream) {
  bb::RasterArgs a{rec,     rec_stride, big_ids, n_big,   big_len, pair_tri,
                   pair_len, ids,       starts,  counts,  nullptr, 1,
                   zkey,    n_slots,    tiles_x, tile_h,  tile_w,  0u,
                   nullptr, nullptr};
  a.n_live = n_live;
  a.ldr = ldr;
  a.ldr_cstride = ldr_cstride;
  return bb::launch_raster<bb::OVERLAY>(a, csize, clusters * csize,
                                        (cudaStream_t)stream);
}

// K1's tail: slot s scans pair_tri[starts[s] ...] for counts[s] candidates
// (no overflow rows; 0: a dead slot) in parts of MIN_PART, continuing the
// keys of frame plane row ids[s] - row_off, and merges its winners into
// zkey and fields (planes fstride floats apart) in place. ends: the
// inclusive prefix sums of ceil(counts[s] / MIN_PART); best ((n_slots,
// npx) 64-bit), arrived ((n_slots,) int) and next (one int) must be zero.
extern "C" int bb_raster_tail(const float* rec, const int* pair_tri,
                              int pair_len, const int* ids,
                              const int* starts, const int* counts,
                              const int* ends, int n_slots, int row_off,
                              int tiles_x, int tile_h, int tile_w,
                              int rec_stride, unsigned mask,
                              unsigned long long* best, int* arrived,
                              int* next, int* zkey, float* fields,
                              long long fstride, void* stream) {
  bb::RasterArgs a{rec,     rec_stride, nullptr, nullptr, 0,     pair_tri,
                   pair_len, ids,       starts,  counts,  nullptr, 1,
                   nullptr, n_slots,    tiles_x, tile_h,  tile_w,  mask,
                   zkey,    fields};
  a.best = best;
  a.arrived = arrived;
  a.next = next;
  a.ends = ends;
  a.row_off = row_off;
  a.fstride = fstride;
  return bb::launch_raster<bb::TAIL>(a, 1, n_slots, (cudaStream_t)stream);
}
