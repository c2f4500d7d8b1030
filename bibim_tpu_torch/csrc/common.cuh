// Device code shared by the raster kernels (K1 raster.cu, K9
// raster_earlyz.cu, K10 raster_gw.cu, K11 raster_fine.cu) and the overlay
// composite (K4, overlay.cu): the candidate coverage/depth test, the
// per-tile candidate scan and the winner's attribute resolve.
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
#include <climits>
#include <stdint.h>

namespace bb {

// Record channel layout (bibim_tpu_torch/ops/fused.py).
constexpr int CH_A = 0, CH_B = 3, CH_C = 6, CH_ZC = 9, CH_WC = 12;
constexpr int CH_ID = 15, CH_U = 16, CH_V = 19, CH_N = 22, CH_T = 31;
constexpr int CH_W = 40, CH_COL = 49, CH_MAT = 58, CH_ZUB = 59;
constexpr int COV_CH = 15;    // coverage coefficients per candidate
constexpr int STAGE = 128;    // candidates staged per shared-memory round
constexpr int THREADS = 256;  // threads per tile block
constexpr int MAX_PPT = 8;    // pixels per thread: tiles up to 2048 px
constexpr int LOW3 = ~7;

__device__ __forceinline__ float plane_eval(float a, float b, float c,
                                            float px, float py) {
  return a * px + b * py + c;
}

// Masked depth key of one candidate at one pixel, and whether the candidate
// covers the pixel inside the depth range (a key of a miss is negative).
__device__ __forceinline__ int cover_test(const float* co, float px,
                                          float py, bool* covers) {
  const float e0 = plane_eval(co[0], co[3], co[6], px, py);
  const float e1 = plane_eval(co[1], co[4], co[7], px, py);
  const float e2 = plane_eval(co[2], co[5], co[8], px, py);
  const float zn = plane_eval(co[9], co[10], co[11], px, py);
  const float wn = plane_eval(co[12], co[13], co[14], px, py);
  const bool ok = e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && wn > 0.f &&
                  zn >= 0.f && zn <= wn;
  const float z = zn * __frcp_rn(wn == 0.f ? 1.f : wn);
  *covers = ok;
  return __float_as_int(ok ? z : -1.f) & LOW3;
}

__device__ __forceinline__ int cover_key(const float* co, float px,
                                         float py) {
  bool ok;
  return cover_test(co, px, py, &ok);
}

// Triangle id of candidate c of a scan that takes the overflow list's nb
// ids first, then pair_tri[start ...]; -1 (a zero record) out of range.
__device__ __forceinline__ int candidate_tri(const int* big_ids, int nb,
                                             const int* pair_tri,
                                             int pair_len, int start, int c) {
  if (c < nb) return big_ids[c];
  const int pi = start + (c - nb);
  return (pi >= 0 && pi < pair_len) ? pair_tri[pi] : -1;
}

// Copies the 15 coverage coefficients of `n` staged triangles into sco
// (zeros for tri < 0), threads t0, t0+step, ... of the caller sharing it.
__device__ __forceinline__ void stage_coeffs(const float* rec, int rec_stride,
                                             const int* stri, int n,
                                             float (*sco)[COV_CH], int t0,
                                             int step) {
  for (int i = t0; i < n * COV_CH; i += step) {
    const int cand = i / COV_CH;
    const int ch = i - cand * COV_CH;
    const int tri = stri[cand];
    sco[cand][ch] = tri >= 0 ? rec[(size_t)tri * rec_stride + ch] : 0.f;
  }
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
      stri[i] = candidate_tri(a.big_ids, a.nb, a.pair_tri, a.pair_len,
                              a.start, base + i);
    }
    __syncthreads();
    stage_coeffs(a.rec, a.rec_stride, stri, n, sco, threadIdx.x, blockDim.x);
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

constexpr int N_FIELDS = 19;  // _OUT_FIELDS of ops/fused.py

// The output planes of one pixel from its winning record (nullptr: no
// winner, every plane 0), in _OUT_FIELDS order.
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

// Writes the depth key and the planes selected by `mask` of pixel p of
// slot s (fields are (popcount(mask), n_slots, npx)).
__device__ inline void write_pixel(const float* rec, int rec_stride,
                                   int best, int key, float px, float py,
                                   unsigned mask, int s, int n_slots, int npx,
                                   int p, int* zkey, float* fields) {
  const size_t o = (size_t)s * npx + p;
  zkey[o] = key;
  float v[N_FIELDS];
  resolve_fields(best >= 0 ? rec + (size_t)best * rec_stride : nullptr, px,
                 py, v);
  int slot = 0;
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    if ((mask >> f) & 1u) {
      fields[((size_t)slot * n_slots + s) * npx + p] = v[f];
      ++slot;
    }
  }
}

}  // namespace bb
