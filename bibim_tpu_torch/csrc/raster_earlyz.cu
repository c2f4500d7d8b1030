// K9 — early-z raster + resolve: K1 with a near-first candidate order, an
// explicit draw-order tie key, and a break once no remaining candidate can
// win.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel with earlyz=True (its loop
// _coverage_loop_earlyz and chunk test _chunk_test_ord). One block per
// slot, 256 threads, up to 8 pixels per thread, as K1. Each pixel carries
// (key, ord, tri): key the masked depth key of common.cuh cover_key, ord
// the record's channel _ID (triangle id + 1; -1 for a candidate that does
// not cover the pixel), starting from init_zkey & ~7 and the okey plane
// of the previous pass. A candidate replaces the running winner when
// key > best || (key == best && ord >= best_ord): the winner is the
// lexicographic argmax of (key, ord) over the candidate set, so any scan
// order gives it, and ties go to the later draw whatever the window
// positions (the big/small split and multi-pass knife-edges of K1 close).
//
// The window (after the overflow list) is sorted per tile by descending
// conservative depth bucket (ops/sort.py sort_pairs_z). After each staged
// round of window candidates the block reduces the round's minimum bucket
// bits(zub) >> zsh and the minimum running key over the tile's pixels;
// when ((bmin + 2) << zsh) <= min key, every remaining candidate's key is
// below every pixel's winner (the reference's condition, with its slack
// of one bucket for ulp overshoot of the per-pixel plane), and the scan
// stops. The break only skips work: the output equals the full scan's.
//
// What bounds it on an H100: the scan's arithmetic, as K1, minus the
// rounds the break skips; each round adds two block reductions. `stats`
// (optional) accumulates (8-row chunks scanned, 8-row chunks present) of
// the windows, so a run can show how often the break fires.
#include "common.cuh"

namespace bb {

constexpr int STAGE_Z = 32;  // candidates per round (the break's grain)

__global__ void __launch_bounds__(THREADS)
raster_earlyz_kernel(const float* __restrict__ rec, int rec_stride,
                     const int* __restrict__ big_ids,
                     const int* __restrict__ n_big, int big_len,
                     const int* __restrict__ pair_tri, int pair_len,
                     const int* __restrict__ ids,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ init_zkey,
                     const float* __restrict__ init_okey, int n_slots,
                     int tiles_x, int tile_h, int tile_w, unsigned mask,
                     int zsh, int* __restrict__ zkey,
                     float* __restrict__ okey, float* __restrict__ fields,
                     unsigned long long* __restrict__ stats) {
  __shared__ float sco[STAGE_Z][COV_CH];
  __shared__ float sord[STAGE_Z];
  __shared__ int stri[STAGE_Z];
  __shared__ int sbucket[STAGE_Z];
  __shared__ int swarp_min[THREADS / 32];
  constexpr int SENTINEL = 1 << 20;  // above any depth bucket
  const int s = blockIdx.x;
  const int npx = tile_h * tile_w;
  float px[MAX_PPT], py[MAX_PPT], bord[MAX_PPT];
  int bkey[MAX_PPT], best[MAX_PPT];
  const int npt = tile_pixels(ids[s], tiles_x, tile_h, tile_w,
                              init_zkey + (size_t)s * npx, px, py, bkey,
                              best);
  for (int k = 0; k < MAX_PPT; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    bord[k] = k < npt ? init_okey[(size_t)s * npx + p] : 0.f;
  }
  const int nb = min(*n_big, big_len);
  const int start = starts[s];
  const int count = counts[s];
  const int total = nb + count;
  int scanned = nb;  // candidate rows tested

  // Overflow rounds, then window rounds: a round never mixes the two, so
  // the bound below reads window candidates only.
  for (int base = 0; base < total;) {
    const int seg_end = base < nb ? nb : total;
    const int n = min(STAGE_Z, seg_end - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int tri =
          candidate_tri(big_ids, nb, pair_tri, pair_len, start, base + i);
      stri[i] = tri;
      const float* r = rec + (size_t)max(tri, 0) * rec_stride;
      sord[i] = tri >= 0 ? r[CH_ID] : 0.f;
      sbucket[i] = tri >= 0 ? (__float_as_int(r[CH_ZUB]) >> zsh) : SENTINEL;
    }
    __syncthreads();
    stage_coeffs(rec, rec_stride, stri, n, sco, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* co = sco[i];
      const int tri = stri[i];
#pragma unroll
      for (int k = 0; k < MAX_PPT; ++k) {
        if (k < npt) {
          bool ok;
          const int key = cover_test(co, px[k], py[k], &ok);
          const float ord = ok ? sord[i] : -1.f;
          if (key > bkey[k] || (key == bkey[k] && ord >= bord[k])) {
            bkey[k] = key;
            bord[k] = ord;
            best[k] = tri;
          }
        }
      }
    }
    const bool window = base >= nb;
    base += n;
    if (window) {
      scanned = base;
      int bmin = SENTINEL;
      for (int i = 0; i < n; ++i) bmin = min(bmin, sbucket[i]);
      int kmin = INT_MAX;
      for (int k = 0; k < npt; ++k) kmin = min(kmin, bkey[k]);
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      if ((threadIdx.x & 31) == 0) swarp_min[threadIdx.x >> 5] = kmin;
      __syncthreads();
      int minbest = INT_MAX;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
        minbest = min(minbest, swarp_min[w]);
      if (bmin < SENTINEL && ((bmin + 2) << zsh) <= minbest) break;
    }
    __syncthreads();
  }
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(&stats[0], (unsigned long long)((scanned - nb + 7) / 8));
    atomicAdd(&stats[1], (unsigned long long)((count + 7) / 8));
  }

  for (int k = 0; k < npt; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    okey[(size_t)s * npx + p] = bord[k];
    write_pixel(rec, rec_stride, best[k], bkey[k], px[k], py[k], mask, s,
                n_slots, npx, p, zkey, fields);
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
                                int* zkey, float* okey, float* fields,
                                unsigned long long* stats, void* stream) {
  if (n_slots > 0) {
    bb::raster_earlyz_kernel<<<n_slots, bb::THREADS, 0,
                               (cudaStream_t)stream>>>(
        rec, rec_stride, big_ids, n_big, big_len, pair_tri, pair_len, ids,
        starts, counts, init_zkey, init_okey, n_slots, tiles_x, tile_h,
        tile_w, mask, zsh, zkey, okey, fields, stats);
  }
  return (int)cudaGetLastError();
}
