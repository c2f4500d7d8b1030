// K1 — raster + resolve + perspective-correct interpolation.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel (launched by
// raster_fused_pallas). One block per 8x128 screen tile (slot), 256 threads,
// 4 pixels per thread. Each thread scans the overflow list and then the
// tile's sorted candidate window (common.cuh scan_tile), keeping the best
// packed depth key with >=, then reads the winner's record row directly and
// writes the requested output planes.
//
// What bounds it on an H100: the scan is compute (about 25 flops per
// candidate per pixel); the records are small and shared by the 1024 pixels
// of a tile, so each candidate's 15 coverage floats are read once per block
// into shared memory and broadcast to all threads. The TPU kernel's one-hot
// MXU resolve (_resolve_winner) is a TPU workaround for the lack of a
// per-pixel gather and is not ported: each pixel reads its winner's record
// (60 floats, L2-resident) by index. Output writes are coalesced (consecutive
// threads own consecutive pixels).
//
// merged_coverage: on the TPU a grid step runs a group of tiles and the
// merged schedule runs one coverage loop for the whole group, at the
// group's largest chunk count. Here a block is one tile and loops only to
// its own count, so that schedule has no counterpart, and the slots keep
// their tile order: sorting them by chunk class made this kernel up to 8 %
// faster on config 4 but cost more in the sort than it saved.
#include "common.cuh"

namespace bb {

__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ rec, int rec_stride,
              const int* __restrict__ big_ids, const int* __restrict__ n_big,
              int big_len, const int* __restrict__ pair_tri, int pair_len,
              const int* __restrict__ ids, const int* __restrict__ starts,
              const int* __restrict__ counts,
              const int* __restrict__ init_zkey, int n_slots, int tiles_x,
              int tile_h, int tile_w, unsigned mask, int* __restrict__ zkey,
              float* __restrict__ fields) {
  __shared__ float sco[STAGE][COV_CH];
  __shared__ int stri[STAGE];
  const int s = blockIdx.x;
  const int npx = tile_h * tile_w;
  float px[MAX_PPT], py[MAX_PPT];
  int bkey[MAX_PPT], best[MAX_PPT];
  const int npt = tile_pixels(ids[s], tiles_x, tile_h, tile_w,
                              init_zkey + (size_t)s * npx, px, py, bkey,
                              best);
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
    write_pixel(rec, rec_stride, best[k], bkey[k], px[k], py[k], mask, s,
                n_slots, npx, threadIdx.x + k * blockDim.x, zkey, fields);
  }
}

}  // namespace bb

extern "C" int bb_raster(const float* rec, const int* big_ids,
                         const int* n_big, int big_len, const int* pair_tri,
                         int pair_len, const int* ids, const int* starts,
                         const int* counts, const int* init_zkey, int n_slots,
                         int tiles_x, int tile_h, int tile_w, int rec_stride,
                         unsigned mask, int* zkey, float* fields,
                         void* stream) {
  if (n_slots > 0) {
    bb::raster_kernel<<<n_slots, bb::THREADS, 0, (cudaStream_t)stream>>>(
        rec, rec_stride, big_ids, n_big, big_len, pair_tri, pair_len, ids,
        starts, counts, init_zkey, n_slots, tiles_x, tile_h, tile_w, mask,
        zkey, fields);
  }
  return (int)cudaGetLastError();
}
