// K11 — fine-subtile raster + resolve: pass 0 binned per 16x8-px subtile,
// one warp per subtile.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel_fine (pass 0 of
// fine_bins frames; passes >= 1 stay on K1). One block per coarse 8x128
// tile, one warp per subtile g of tile_w / nsub x tile_h pixels (128 px,
// 4 per lane at 8x128). Each warp scans the overflow list, then its own
// fine window pair_tri[start + lb_al[g] ...][:cntk[g]] of the tile's
// coarse window, keeping the best packed key with >=, and writes its
// pixels in screen order (the TPU kernel's fine-ordered (k, 8, 8, 16)
// layout and the transposes around it are not ported). Bases align down
// to 8 rows: the up to 7 prefix rows retested belong to the previous
// subtile, and a triangle covering this subtile also has its own pair
// here, at a later position, so it wins the duplicate tie and the result
// is exact.
//
// What bounds it on an H100: the scan's arithmetic, about 1/nsub of K1's
// per candidate (each candidate is tested against 128 pixels, not 1024).
// Warps stage their candidates in private shared-memory slices and
// synchronize only within the warp, so a subtile with few candidates
// finishes early instead of running to the deepest subtile of the tile
// (the TPU kernel's lockstep loop does).
#include "common.cuh"

namespace bb {

constexpr int WSTAGE = 32;     // candidates staged per warp round
constexpr int MAX_NSUB = 8;

// One warp's scan of src[start, start + count) (ids < src_len, others a
// zero record) against its lanes' pixels.
__device__ inline void warp_scan(const float* rec, int rec_stride,
                                 const int* src, int src_len, int start,
                                 int count, const float* px, const float* py,
                                 int* bkey, int* best, int npl,
                                 float (*sco)[COV_CH], int* stri) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < count; base += WSTAGE) {
    const int n = min(WSTAGE, count - base);
    if (lane < n) {
      const int pi = start + base + lane;
      stri[lane] = (pi >= 0 && pi < src_len) ? src[pi] : -1;
    }
    __syncwarp();
    stage_coeffs(rec, rec_stride, stri, n, sco, lane, 32);
    __syncwarp();
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k < MAX_PPT; ++k) {
        if (k < npl) {
          const int key = cover_key(sco[i], px[k], py[k]);
          if (key >= bkey[k]) {
            bkey[k] = key;
            best[k] = stri[i];
          }
        }
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(MAX_NSUB * 32)
raster_fine_kernel(const float* __restrict__ rec, int rec_stride,
                   const int* __restrict__ big_ids,
                   const int* __restrict__ n_big, int big_len,
                   const int* __restrict__ pair_tri, int pair_len,
                   const int* __restrict__ ids,
                   const int* __restrict__ starts,
                   const int* __restrict__ lb_al,
                   const int* __restrict__ cntk,
                   const int* __restrict__ init_zkey, int n_slots, int nsub,
                   int tiles_x, int tile_h, int tile_w, unsigned mask,
                   int* __restrict__ zkey, float* __restrict__ fields) {
  __shared__ float sco[MAX_NSUB][WSTAGE][COV_CH];
  __shared__ int stri[MAX_NSUB][WSTAGE];
  const int s = blockIdx.x;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int npx = tile_h * tile_w;
  const int sub_w = tile_w / nsub;
  const int npl = tile_h * sub_w / 32;
  const int tid = ids[s];
  const int row = tid / tiles_x;
  const int col = tid - row * tiles_x;
  float px[MAX_PPT], py[MAX_PPT];
  int bkey[MAX_PPT], best[MAX_PPT], pix[MAX_PPT];
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int l = lane + 32 * k;
    const int x = g * sub_w + l % sub_w;
    const int y = l / sub_w;
    best[k] = -1;
    pix[k] = y * tile_w + x;
    px[k] = (float)(col * tile_w + x) + 0.5f;
    py[k] = (float)(row * tile_h + y) + 0.5f;
    bkey[k] = k < npl ? init_zkey[(size_t)s * npx + pix[k]] & LOW3 : 0;
  }
  warp_scan(rec, rec_stride, big_ids, min(*n_big, big_len), 0,
            min(*n_big, big_len), px, py, bkey, best, npl, sco[g], stri[g]);
  warp_scan(rec, rec_stride, pair_tri, pair_len,
            starts[s] + lb_al[s * nsub + g], cntk[s * nsub + g], px, py,
            bkey, best, npl, sco[g], stri[g]);
  for (int k = 0; k < npl; ++k) {
    write_pixel(rec, rec_stride, best[k], bkey[k], px[k], py[k], mask, s,
                n_slots, npx, pix[k], zkey, fields);
  }
}

}  // namespace bb

extern "C" int bb_raster_fine(const float* rec, const int* big_ids,
                              const int* n_big, int big_len,
                              const int* pair_tri, int pair_len,
                              const int* ids, const int* starts,
                              const int* lb_al, const int* cntk,
                              const int* init_zkey, int n_slots, int nsub,
                              int tiles_x, int tile_h, int tile_w,
                              int rec_stride, unsigned mask, int* zkey,
                              float* fields, void* stream) {
  if (n_slots > 0) {
    bb::raster_fine_kernel<<<n_slots, nsub * 32, 0, (cudaStream_t)stream>>>(
        rec, rec_stride, big_ids, n_big, big_len, pair_tri, pair_len, ids,
        starts, lb_al, cntk, init_zkey, n_slots, nsub, tiles_x, tile_h,
        tile_w, mask, zkey, fields);
  }
  return (int)cudaGetLastError();
}
