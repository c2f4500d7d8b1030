// K9 — early-z raster + resolve: K1 with a near-first candidate order, an
// explicit draw-order tie key, and a break once no remaining candidate can
// win.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel with earlyz=True (its loop
// _coverage_loop_earlyz and chunk test _chunk_test_ord). Slot s rasterizes
// one screen tile from its candidate sequence: the overflow list, then its
// window. Each pixel carries (key, ord, index): key the masked depth key of
// common.cuh, ord the record's channel _ID (triangle id + 1; -1 for a
// candidate that does not cover the pixel), starting from init_zkey & ~7
// and the okey plane of the previous pass. A candidate replaces the running
// winner when key > best || (key == best && ord >= best_ord): the winner
// is the lexicographic argmax of (key, ord, position) over the initial
// value (position -1) and the candidates.
//
// The window (after the overflow list) is sorted per tile by descending
// conservative depth bucket (ops/sort.py sort_pairs_z). After each staged
// round the block reduces the round's minimum window bucket
// bits(zub) >> zsh and the minimum running key over the tile's pixels;
// when ((bmin + 2) << zsh) <= min key, every remaining candidate's key is
// below every pixel's winner (the reference's condition, with its slack of
// one bucket for ulp overshoot of the per-pixel plane), and the scan stops.
// The break only skips work: the output equals the full scan's.
//
// What bounds it on an H100: operations, as K1 — about 25 per candidate and
// pixel — minus the rounds the break skips. One block per slot left the
// longest window to one SM while the others idled, so the design is K1's:
//   - A slot's sequence is split into `csize` contiguous parts, scanned by
//     the blocks of one thread-block cluster (common.cuh cluster_part).
//     Rank 0 starts from the initial (key, ord); the other parts start
//     below every candidate (key INT_MIN), so the initial value enters the
//     merge once. Rank 0 folds the parts in rank order through
//     distributed shared memory with the same rule, which gives the
//     sequential result (a later part wins a tie on (key, ord), as a later
//     candidate does). A part breaks on max(initial key, its own running
//     key) per pixel: a lower bound of the sequential running key, so the
//     break stays exact within the part.
//   - The three edge functions come first; when no lane of the warp passes
//     them, the depth planes and the reciprocal are skipped (a miss's key
//     and ord do not depend on them; the comparison still runs, so a miss
//     ties an initial miss key as in the sequential scan).
//   - Each candidate's first 16 floats (coverage, _ID) and its bucket
//     channel _ZUB are staged 128 a round with cp.async, double-buffered;
//     the break test shares the round's closing barrier. Rounds of 128
//     ran 0.7-2 % faster than rounds of 32 or 64 on config 4's early-z
//     frames, though their break skipped no chunk there where rounds of
//     32 skipped 0.56 % (H100, tools/raster_variants.py; PERF.md).
// `stats` (optional) accumulates (8-row chunks of window rows scanned,
// summed over a slot's parts; 8-row chunks present).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace bb {

constexpr int EZ_STAGE = 128;  // candidates per round (the break's grain)
static_assert(2 * EZ_STAGE <= THREADS, "two staging threads a candidate");
constexpr int SENTINEL = 1 << 20;  // above any depth bucket

struct EarlyzArgs {
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
  const int* init_zkey;
  const float* init_okey;
  int n_slots, tiles_x, tile_h, tile_w;
  unsigned mask;
  int zsh;
  int* zkey;
  float* okey;
  float* fields;
  unsigned long long* stats;
};

template <int PPT>
__global__ void __launch_bounds__(THREADS)
raster_earlyz_kernel(const EarlyzArgs a, int csize) {
  // The staging rounds, then (split slots) each pixel's (key, ord, index)
  // for the merge, in the same bytes.
  constexpr int STAGE_BYTES = 2 * EZ_STAGE * STAGE_CH * 4;
  constexpr int MERGE_BYTES = 3 * PPT * THREADS * 4;
  __shared__ __align__(16) float smem[(STAGE_BYTES > MERGE_BYTES
                                           ? STAGE_BYTES
                                           : MERGE_BYTES) / 4];
  __shared__ int stri[2][EZ_STAGE];
  __shared__ float szub[2][EZ_STAGE];
  __shared__ int sred[2][2][THREADS / 32];  // round parity: key, bucket min
  __shared__ int srows;                     // window rows this part scanned
  float (*sco)[EZ_STAGE][STAGE_CH] =
      reinterpret_cast<float (*)[EZ_STAGE][STAGE_CH]>(smem);

  const int s = blockIdx.x / csize;
  const int rank = blockIdx.x - s * csize;
  const int nb = min(*a.n_big, a.big_len);
  const int start = a.starts[s];
  const int count = a.counts[s];
  int lo, hi;
  const int parts = cluster_part(nb + count, csize, rank, &lo, &hi);
  if (parts <= 1 && rank != 0) return;
  const int npx = a.tile_h * a.tile_w;
  const int tid = a.ids[s];
  const int row = tid / a.tiles_x, col = tid - row * a.tiles_x;
  float px[PPT], py[PPT], bord[PPT];
  int ikey[PPT], bkey[PPT], bidx[PPT];
  int npt = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    px[k] = py[k] = 0.f;
    ikey[k] = 0;
    bord[k] = -1.f;
    bidx[k] = -1;
    if (p < npx) {
      npt = k + 1;
      px[k] = (float)(p % a.tile_w + col * a.tile_w) + 0.5f;
      py[k] = (float)(p / a.tile_w + row * a.tile_h) + 0.5f;
      ikey[k] = a.init_zkey[(size_t)s * npx + p] & LOW3;
      if (rank == 0) bord[k] = a.init_okey[(size_t)s * npx + p];
    }
    bkey[k] = rank == 0 ? ikey[k] : INT_MIN;
  }

  // Two threads stage each of a round's candidates: 8 floats each, and the
  // second also its _ZUB; the first records the triangle id.
  const int cand = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int rounds = (hi - lo + EZ_STAGE - 1) / EZ_STAGE;
  auto tri_at = [&](int c) {
    return c < hi ? candidate_tri(a.big_ids, nb, a.pair_tri, a.pair_len,
                                  start, c)
                  : -1;
  };
  auto stage = [&](int buf, int tri) {
    if (cand < EZ_STAGE) {
      stage_row(sco[buf][cand], a.rec, a.rec_stride, tri, 2 * half, 2);
      if (half) {
        const bool ok = tri >= 0;
        cp_async4(&szub[buf][cand],
                  a.rec + (ok ? (size_t)tri * a.rec_stride + CH_ZUB : 0), ok);
      } else {
        stri[buf][cand] = tri;
      }
    }
    cp_async_commit();
  };
  int tri_next = -1;
  if (rounds > 0) stage(0, tri_at(lo + cand));
  if (rounds > 1) tri_next = tri_at(lo + EZ_STAGE + cand);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int rows = 0;
  for (int r = 0; r < rounds; ++r) {
    const int c0 = lo + r * EZ_STAGE;
    const int buf = r & 1;
    if (r + 1 < rounds) {
      stage(buf ^ 1, tri_next);
      if (r + 2 < rounds) tri_next = tri_at(c0 + 2 * EZ_STAGE + cand);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(EZ_STAGE, hi - c0);
    for (int i = 0; i < n; ++i) {
      const Staged st = load_staged(sco[buf][i]);
      const float* co = st.co;
      bool in[PPT];
      bool any_in = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        in[k] = k < npt && edges_in(co, px[k], py[k]);
        any_in |= in[k];
      }
      const int c = c0 + i;
      if (__any_sync(0xffffffffu, any_in)) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (k < npt) {
            int key = MISS_KEY;
            float ord = -1.f;
            if (in[k]) {
              bool ok;
              key = depth_key(co, px[k], py[k], &ok);
              ord = ok ? co[CH_ID] : -1.f;
            }
            if (key > bkey[k] || (key == bkey[k] && ord >= bord[k])) {
              bkey[k] = key;
              bord[k] = ord;
              bidx[k] = c;
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (k < npt && (MISS_KEY > bkey[k] ||
                          (MISS_KEY == bkey[k] && -1.f >= bord[k]))) {
            bkey[k] = MISS_KEY;
            bord[k] = -1.f;
            bidx[k] = c;
          }
        }
      }
    }
    rows += max(0, c0 + n - max(c0, nb));
    if (r + 1 == rounds) break;
    // The break test: the round's window buckets and the running keys.
    if (c0 + n > nb) {
      int b = SENTINEL;
      if (threadIdx.x < n && c0 + (int)threadIdx.x >= nb &&
          stri[buf][threadIdx.x] >= 0)
        b = __float_as_int(szub[buf][threadIdx.x]) >> a.zsh;
      int kmin = INT_MAX;
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (k < npt) kmin = min(kmin, max(bkey[k], ikey[k]));
      b = __reduce_min_sync(0xffffffffu, b);
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      if (lane == 0) {
        sred[buf][0][warp] = kmin;
        sred[buf][1][warp] = b;
      }
    }
    __syncthreads();
    if (c0 + n > nb) {
      int minbest = INT_MAX, bmin = SENTINEL;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        minbest = min(minbest, sred[buf][0][w]);
        bmin = min(bmin, sred[buf][1][w]);
      }
      if (bmin < SENTINEL && ((bmin + 2) << a.zsh) <= minbest) break;
    }
  }
  // A break leaves the next round's copies in flight; they land before the
  // merge reuses their bytes.
  cp_async_wait<0>();

  if (parts > 1) {
    // Merge the parts in rank order: each block's (key, ord, index) per
    // pixel in the staging bytes, read by rank 0 across the cluster.
    cg::cluster_group cl = cg::this_cluster();
    __syncthreads();  // every thread is past its last read of the rounds
    int* mkey = reinterpret_cast<int*>(smem);
    float* mord = smem + PPT * THREADS;
    int* midx = reinterpret_cast<int*>(smem) + 2 * PPT * THREADS;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = threadIdx.x + k * THREADS;
      mkey[p] = bkey[k];
      mord[p] = bord[k];
      midx[p] = bidx[k];
    }
    if (threadIdx.x == 0) srows = rows;
    cl.sync();
    if (rank == 0) {
      for (int o = 1; o < parts; ++o) {
        const int* okey_o = cl.map_shared_rank(mkey, o);
        const float* oord = cl.map_shared_rank(mord, o);
        const int* oidx = cl.map_shared_rank(midx, o);
        if (threadIdx.x == 0) rows += *cl.map_shared_rank(&srows, o);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int p = threadIdx.x + k * THREADS;
          const int key = okey_o[p];
          const float ord = oord[p];
          if (key > bkey[k] || (key == bkey[k] && ord >= bord[k])) {
            bkey[k] = key;
            bord[k] = ord;
            bidx[k] = oidx[p];
          }
        }
      }
    }
    cl.sync();  // the other blocks' shared memory stays until rank 0 read it
    if (rank != 0) return;
  }
  if (a.stats != nullptr && threadIdx.x == 0) {
    atomicAdd(&a.stats[0], (unsigned long long)((rows + 7) / 8));
    atomicAdd(&a.stats[1], (unsigned long long)((count + 7) / 8));
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (k < npt) {
      const int p = threadIdx.x + k * THREADS;
      const int tri = bidx[k] < 0 ? -1
                                  : candidate_tri(a.big_ids, nb, a.pair_tri,
                                                  a.pair_len, start, bidx[k]);
      a.okey[(size_t)s * npx + p] = bord[k];
      write_pixel(a.rec, a.rec_stride, tri, bkey[k], px[k], py[k], a.mask, s,
                  a.n_slots, npx, p, a.zkey, a.fields);
    }
  }
}

}  // namespace bb

extern "C" int bb_raster_earlyz(const float* rec, const int* big_ids,
                                const int* n_big, int big_len,
                                const int* pair_tri, int pair_len,
                                const int* ids, const int* starts,
                                const int* counts, const int* init_zkey,
                                const float* init_okey, int n_slots,
                                int tiles_x, int tile_h, int tile_w,
                                int rec_stride, unsigned mask, int zsh,
                                int csize, int* zkey, float* okey,
                                float* fields, unsigned long long* stats,
                                void* stream) {
  const int npx = tile_h * tile_w;
  if (npx <= 0 || npx > bb::THREADS * bb::MAX_PPT || rec_stride % 4 != 0 ||
      rec_stride <= bb::CH_ZUB ||
      (csize != 1 && csize != 2 && csize != 4 && csize != 8))
    return (int)cudaErrorInvalidValue;
  if (n_slots <= 0) return (int)cudaGetLastError();
  const bb::EarlyzArgs a{rec,     rec_stride, big_ids, n_big,    big_len,
                         pair_tri, pair_len,  ids,     starts,   counts,
                         init_zkey, init_okey, n_slots, tiles_x, tile_h,
                         tile_w,  mask,       zsh,     zkey,     okey,
                         fields,  stats};
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = n_slots * csize;
  auto go = [&](auto kernel) {
    return bb::launch_clustered(kernel, grid, bb::THREADS, csize, st, a,
                                csize);
  };
  if (npx <= bb::THREADS) return go(bb::raster_earlyz_kernel<1>);
  if (npx <= 2 * bb::THREADS) return go(bb::raster_earlyz_kernel<2>);
  if (npx <= 4 * bb::THREADS) return go(bb::raster_earlyz_kernel<4>);
  return go(bb::raster_earlyz_kernel<8>);
}
