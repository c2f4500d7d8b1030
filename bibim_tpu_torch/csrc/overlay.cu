// K4 — depth-tested flat-colour overlay composite over a compact tile list.
//
// Replaces bibim_tpu/ops/fused.py:_overlay_kernel (launched by
// composite_overlay_pallas). One block per live slot of the compacted tile
// list; the same overflow-then-window scan as K1 (common.cuh), continuing
// the scene's depth keys, then where an overlay triangle wins, its
// interpolated vertex colour replaces the LDR pixel in place. Slots past
// n_live (padding of a list sized for the worst frame) return at once, so
// no two blocks write the same tile.
//
// What bounds it on an H100: launch and scan latency — the light spheres
// touch a few dozen tiles with a few hundred small triangles. Reading the
// tile's depth keys and LDR pixels by tile id (instead of gathering them
// into a compact copy and scattering back, as the TPU version does) keeps
// the pass to one kernel that touches only the covered tiles.
#include "common.cuh"

namespace bb {

__global__ void __launch_bounds__(THREADS)
overlay_kernel(const float* __restrict__ rec, int rec_stride,
               const int* __restrict__ big_ids, const int* __restrict__ n_big,
               int big_len, const int* __restrict__ pair_tri, int pair_len,
               const int* __restrict__ ids, const int* __restrict__ starts,
               const int* __restrict__ counts,
               const int* __restrict__ n_live, const int* __restrict__ zkey,
               float* __restrict__ ldr, int nt, int tiles_x, int tile_h,
               int tile_w) {
  __shared__ float sco[STAGE][COV_CH];
  __shared__ int stri[STAGE];
  const int s = blockIdx.x;
  if (s >= *n_live) return;  // uniform across the block
  const int npx = tile_h * tile_w;
  const int tid = ids[s];
  float px[MAX_PPT], py[MAX_PPT];
  int bkey[MAX_PPT], best[MAX_PPT];
  const int npt = tile_pixels(tid, tiles_x, tile_h, tile_w,
                              zkey + (size_t)tid * npx, px, py, bkey, best);
  TileScan a;
  a.rec = rec;
  a.rec_stride = rec_stride;
  a.big_ids = big_ids;
  a.nb = min(*n_big, big_len);
  a.pair_tri = pair_tri;
  a.pair_len = pair_len;
  a.start = starts[s];
  a.count = counts[s];
  scan_tile(a, px, py, bkey, best, npt, sco, stri);

  for (int k = 0; k < npt; ++k) {
    if (best[k] < 0) continue;
    const float* r = rec + (size_t)best[k] * rec_stride;
    if (!(r[CH_ID] >= 0.5f)) continue;
    float e[3], inv;
    bary(r, px[k], py[k], e, &inv);
    const float b0 = e[0] * inv, b1 = e[1] * inv, b2 = e[2] * inv;
    const int p = threadIdx.x + k * blockDim.x;
    for (int c = 0; c < 3; ++c) {
      ldr[((size_t)c * nt + tid) * npx + p] =
          blend3(r, CH_COL + 3 * c, b0, b1, b2);
    }
  }
}

}  // namespace bb

extern "C" int bb_overlay(const float* rec, const int* big_ids,
                          const int* n_big, int big_len, const int* pair_tri,
                          int pair_len, const int* ids, const int* starts,
                          const int* counts, const int* n_live,
                          const int* zkey, float* ldr, int n_slots, int nt,
                          int tiles_x, int tile_h, int tile_w, int rec_stride,
                          void* stream) {
  if (n_slots > 0) {
    bb::overlay_kernel<<<n_slots, bb::THREADS, 0, (cudaStream_t)stream>>>(
        rec, rec_stride, big_ids, n_big, big_len, pair_tri, pair_len, ids,
        starts, counts, n_live, zkey, ldr, nt, tiles_x, tile_h, tile_w);
  }
  return (int)cudaGetLastError();
}
