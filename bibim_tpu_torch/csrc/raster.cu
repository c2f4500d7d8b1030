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
#include "common.cuh"

namespace bb {

constexpr int N_FIELDS = 19;  // _OUT_FIELDS

__device__ inline void resolve_fields(const float* r, float px, float py,
                                      float* v) {
  if (r == nullptr) {
    for (int f = 0; f < N_FIELDS; ++f) v[f] = 0.f;
    return;
  }
  const float idf = r[CH_ID];
  const bool hit = idf >= 0.5f;
  float e[3], inv;
  bary(r, px, py, e, &inv);
  const float b0 = hit ? e[0] * inv : 0.f;
  const float b1 = hit ? e[1] * inv : 0.f;
  const float b2 = hit ? e[2] * inv : 0.f;
  const float zn = plane_eval(r[CH_ZC], r[CH_ZC + 1], r[CH_ZC + 2], px, py);
  const float wn = plane_eval(r[CH_WC], r[CH_WC + 1], r[CH_WC + 2], px, py);
  v[0] = hit ? zn * __frcp_rn(wn == 0.f ? 1.f : wn) : 0.f;  // depth
  v[1] = idf;
  v[2] = blend3(r, CH_U, b0, b1, b2);
  v[3] = blend3(r, CH_V, b0, b1, b2);
  for (int k = 0; k < 3; ++k) {
    v[4 + k] = blend3(r, CH_N + 3 * k, b0, b1, b2);
    v[7 + k] = blend3(r, CH_T + 3 * k, b0, b1, b2);
    v[10 + k] = blend3(r, CH_W + 3 * k, b0, b1, b2);
    v[13 + k] = blend3(r, CH_COL + 3 * k, b0, b1, b2);
  }
  v[16] = r[CH_MAT];
  v[17] = b0;
  v[18] = b1;
}

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
    const int p = threadIdx.x + k * blockDim.x;
    const size_t o = (size_t)s * npx + p;
    zkey[o] = bkey[k];
    float v[N_FIELDS];
    resolve_fields(best[k] >= 0 ? rec + (size_t)best[k] * rec_stride
                                : nullptr,
                   px[k], py[k], v);
    int slot = 0;
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f) {
      if ((mask >> f) & 1u) {
        fields[((size_t)slot * n_slots + s) * npx + p] = v[f];
        ++slot;
      }
    }
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
