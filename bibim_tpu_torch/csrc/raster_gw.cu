// K10 — group-window raster + resolve: one candidate window per group of
// compact slots, staged through shared memory once for the whole group.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel_gw (single-pass frames
// with group_pair_cap). The sorted pair list is contiguous in compact-slot
// order, so the `group` tiles of a block share one window of the list
// starting at win[g]; tile j scans the overflow list, then the rows
// [lb_al[j], lb_al[j] + cnt_k[j]) of that window (8-aligned bases: the
// up to 7 prefix rows belong to the previous tile and cannot cover this
// one, or are that triangle's duplicate). One block per group, 1024
// threads, up to 8 pixels per thread (group * tile pixels <= 8192); a
// thread's k-th pixel lies in tile (threadIdx.x + k*1024) / npx, so a
// warp's lanes share a tile and a candidate range. The TPU kernel's
// single one-hot resolve over the group's pixels is not ported: each pixel
// reads its winner's record by index, as K1.
//
// What bounds it on an H100: the scan's arithmetic, as K1. The design
// reads each window row's 15 coverage floats once per group instead of
// once per tile (the TPU version's point: one DMA per group).
#include "common.cuh"

namespace bb {

constexpr int THREADS_GW = 1024;
constexpr int STAGE_GW = 256;
constexpr int MAX_GROUP = 8;

__global__ void __launch_bounds__(THREADS_GW)
raster_gw_kernel(const float* __restrict__ rec, int rec_stride,
                 const int* __restrict__ big_ids,
                 const int* __restrict__ n_big, int big_len,
                 const int* __restrict__ pair_tri, int pair_len,
                 const int* __restrict__ ids, const int* __restrict__ win,
                 const int* __restrict__ lb_al,
                 const int* __restrict__ cnt_k,
                 const int* __restrict__ init_zkey, int n_slots, int group,
                 int tiles_x, int tile_h, int tile_w, unsigned mask,
                 int* __restrict__ zkey, float* __restrict__ fields) {
  __shared__ float sco[STAGE_GW][COV_CH];
  __shared__ int stri[STAGE_GW];
  __shared__ int slo[MAX_GROUP], shi[MAX_GROUP];
  const int g = blockIdx.x;
  const int npx = tile_h * tile_w;
  const int gpx = group * npx;
  float px[MAX_PPT], py[MAX_PPT];
  int bkey[MAX_PPT], best[MAX_PPT];
  int npt = 0;
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    best[k] = -1;
    px[k] = py[k] = 0.f;
    bkey[k] = 0;
    if (q < gpx) {
      npt = k + 1;
      const int j = q / npx;
      const int p = q - j * npx;
      const int s = g * group + j;
      const int tid = ids[s];
      const int row = tid / tiles_x;
      const int col = tid - row * tiles_x;
      px[k] = (float)(p % tile_w + col * tile_w) + 0.5f;
      py[k] = (float)(p / tile_w + row * tile_h) + 0.5f;
      bkey[k] = init_zkey[(size_t)s * npx + p] & LOW3;
    }
  }
  if (threadIdx.x < group) {
    const int s = g * group + threadIdx.x;
    slo[threadIdx.x] = lb_al[s];
    shi[threadIdx.x] = lb_al[s] + cnt_k[s];
  }

  // The overflow list, shared by every tile of the group.
  const int nb = min(*n_big, big_len);
  for (int base = 0; base < nb; base += STAGE_GW) {
    const int n = min(STAGE_GW, nb - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      stri[i] = big_ids[base + i];
    __syncthreads();
    stage_coeffs(rec, rec_stride, stri, n, sco, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k < MAX_PPT; ++k) {
        if (k < npt) {
          const int key = cover_key(sco[i], px[k], py[k]);
          if (key >= bkey[k]) {
            bkey[k] = key;
            best[k] = stri[i];
          }
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();

  // The group's window rows [wlo, whi), staged once.
  int wlo = INT_MAX, whi = 0;
  for (int j = 0; j < group; ++j) {
    if (shi[j] > slo[j]) {
      wlo = min(wlo, slo[j]);
      whi = max(whi, shi[j]);
    }
  }
  const int w0 = win[g];
  for (int r0 = wlo; r0 < whi; r0 += STAGE_GW) {
    const int n = min(STAGE_GW, whi - r0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int pi = w0 + r0 + i;
      stri[i] = (pi >= 0 && pi < pair_len) ? pair_tri[pi] : -1;
    }
    __syncthreads();
    stage_coeffs(rec, rec_stride, stri, n, sco, threadIdx.x, blockDim.x);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_PPT; ++k) {
      if (k < npt) {
        const int j = (threadIdx.x + k * blockDim.x) / npx;
        const int lo = max(slo[j], r0) - r0;
        const int hi = min(shi[j], r0 + n) - r0;
        for (int i = lo; i < hi; ++i) {
          const int key = cover_key(sco[i], px[k], py[k]);
          if (key >= bkey[k]) {
            bkey[k] = key;
            best[k] = stri[i];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int k = 0; k < npt; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int j = q / npx;
    write_pixel(rec, rec_stride, best[k], bkey[k], px[k], py[k], mask,
                g * group + j, n_slots, npx, q - j * npx, zkey, fields);
  }
}

}  // namespace bb

extern "C" int bb_raster_gw(const float* rec, const int* big_ids,
                            const int* n_big, int big_len,
                            const int* pair_tri, int pair_len,
                            const int* ids, const int* win,
                            const int* lb_al, const int* cnt_k,
                            const int* init_zkey, int n_slots, int group,
                            int tiles_x, int tile_h, int tile_w,
                            int rec_stride, unsigned mask, int* zkey,
                            float* fields, void* stream) {
  if (n_slots > 0) {
    bb::raster_gw_kernel<<<n_slots / group, bb::THREADS_GW, 0,
                           (cudaStream_t)stream>>>(
        rec, rec_stride, big_ids, n_big, big_len, pair_tri, pair_len, ids,
        win, lb_al, cnt_k, init_zkey, n_slots, group, tiles_x, tile_h,
        tile_w, mask, zkey, fields);
  }
  return (int)cudaGetLastError();
}
