// Device code shared by the raster kernel (K1, raster.cu) and the overlay
// composite (K4, overlay.cu): the candidate coverage/depth test and the
// per-tile candidate scan.
//
// Semantics (the reference kernel's, bibim_tpu/ops/fused.py _chunk_test):
// homogeneous edge functions E_e = A_e*px + B_e*py + C_e, coverage when all
// three are >= 0, inside the depth range 0 <= zn <= wn with wn > 0; the
// reversed-Z packed key is bits(z) & ~7 with z = zn * rcp(wn), and a
// candidate replaces the running winner when its key is >= the running key,
// so the later candidate wins a tie. The whole library is compiled with
// -fmad=false: every a*b+c below rounds the product and the sum separately,
// as the plain PyTorch versions do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bb {

// Record channel layout (bibim_tpu_torch/ops/fused.py).
constexpr int CH_A = 0, CH_B = 3, CH_C = 6, CH_ZC = 9, CH_WC = 12;
constexpr int CH_ID = 15, CH_U = 16, CH_V = 19, CH_N = 22, CH_T = 31;
constexpr int CH_W = 40, CH_COL = 49, CH_MAT = 58;
constexpr int COV_CH = 15;    // coverage coefficients per candidate
constexpr int STAGE = 128;    // candidates staged per shared-memory round
constexpr int THREADS = 256;  // threads per tile block
constexpr int MAX_PPT = 8;    // pixels per thread: tiles up to 2048 px
constexpr int LOW3 = ~7;

__device__ __forceinline__ float plane_eval(float a, float b, float c,
                                            float px, float py) {
  return a * px + b * py + c;
}

// Masked depth key of one candidate at one pixel; negative where the
// candidate does not cover the pixel inside the depth range.
__device__ __forceinline__ int cover_key(const float* co, float px,
                                         float py) {
  const float e0 = plane_eval(co[0], co[3], co[6], px, py);
  const float e1 = plane_eval(co[1], co[4], co[7], px, py);
  const float e2 = plane_eval(co[2], co[5], co[8], px, py);
  const float zn = plane_eval(co[9], co[10], co[11], px, py);
  const float wn = plane_eval(co[12], co[13], co[14], px, py);
  const bool ok = e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && wn > 0.f &&
                  zn >= 0.f && zn <= wn;
  const float z = zn * __frcp_rn(wn == 0.f ? 1.f : wn);
  return __float_as_int(ok ? z : -1.f) & LOW3;
}

struct TileScan {
  const float* rec;     // (T, rec_stride) records
  int rec_stride;
  const int* big_ids;   // overflow triangle ids, first nb live
  int nb;
  const int* pair_tri;  // sorted pair list (triangle ids)
  int pair_len;
  int start;            // this tile's window [start, start + count)
  int count;
};

// Scans the overflow list, then the tile's window, in order; candidate
// coefficients are staged through shared memory STAGE at a time. bkey/best
// hold the running key and winning triangle id of this thread's pixels.
__device__ inline void scan_tile(const TileScan& a, const float* px,
                                 const float* py, int* bkey, int* best,
                                 int npt, float (*sco)[COV_CH], int* stri) {
  const int total = a.nb + a.count;
  for (int base = 0; base < total; base += STAGE) {
    const int n = min(STAGE, total - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = base + i;
      int tri;
      if (c < a.nb) {
        tri = a.big_ids[c];
      } else {
        const int pi = a.start + (c - a.nb);
        tri = (pi >= 0 && pi < a.pair_len) ? a.pair_tri[pi] : -1;
      }
      stri[i] = tri;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * COV_CH; i += blockDim.x) {
      const int cand = i / COV_CH;
      const int ch = i - cand * COV_CH;
      const int tri = stri[cand];
      sco[cand][ch] = tri >= 0 ? a.rec[(size_t)tri * a.rec_stride + ch] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* co = sco[i];
      const int tri = stri[i];
#pragma unroll
      for (int k = 0; k < MAX_PPT; ++k) {
        if (k < npt) {
          const int key = cover_key(co, px[k], py[k]);
          if (key >= bkey[k]) {
            bkey[k] = key;
            best[k] = tri;
          }
        }
      }
    }
    __syncthreads();
  }
}

// Pixel centres and initial keys of this thread's pixels in tile `tid`.
// Returns the number of pixels the thread owns.
__device__ inline int tile_pixels(int tid, int tiles_x, int tile_h,
                                  int tile_w, const int* init_key, float* px,
                                  float* py, int* bkey, int* best) {
  const int npx = tile_h * tile_w;
  const int row = tid / tiles_x;
  const int col = tid - row * tiles_x;
  int npt = 0;
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    best[k] = -1;
    if (p < npx) {
      npt = k + 1;
      px[k] = (float)(p % tile_w + col * tile_w) + 0.5f;
      py[k] = (float)(p / tile_w + row * tile_h) + 0.5f;
      bkey[k] = init_key[p] & LOW3;
    } else {
      px[k] = py[k] = 0.f;
      bkey[k] = 0;
    }
  }
  return npt;
}

// Barycentric weights e_k / (e0 + e1 + e2) of a winning record.
__device__ __forceinline__ void bary(const float* r, float px, float py,
                                     float* e, float* inv) {
  for (int k = 0; k < 3; ++k)
    e[k] = plane_eval(r[CH_A + k], r[CH_B + k], r[CH_C + k], px, py);
  const float esum = e[0] + e[1] + e[2];
  *inv = __frcp_rn(esum == 0.f ? 1.f : esum);
}

__device__ __forceinline__ float blend3(const float* r, int base, float b0,
                                        float b1, float b2) {
  return r[base] * b0 + r[base + 1] * b1 + r[base + 2] * b2;
}

}  // namespace bb
