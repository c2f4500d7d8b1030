// Device code shared by the sampled shade (K2, shade.cu), the G-buffer shade
// (K5, gbuffer_shade.cu) and the standalone samplers (K6 / K7, sample.cu):
// the bilinear footprint and texel blends of the material tables, and the
// GGX light loop.
//
// Semantics are the reference's (bibim_tpu/ops/texture_quad.py _footprint,
// _blend, block_blend_acc; bibim_tpu/ops/shading_pallas.py _ggx_light_sum),
// operation for operation. The library is compiled with -fmad=false, so
// every a*b+c rounds the product and the sum separately, as the plain
// PyTorch versions do.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bb {

constexpr int MAX_GROUPS = 4;
constexpr int N_SLOTS = 10;  // alb_rgb, nrm_xyz, metallic, roughness, ao, height
constexpr int LIGHT_ROW = 16;  // scene/lights.py pack_lights
constexpr float PI_F = (float)3.1415926535897932384626433832795;
constexpr float INV255 = (float)(1.0 / 255.0);

}  // namespace bb

// Mirror of bibim_tpu_torch._build.Groups.
struct ShadeGroups {
  int n;
  int kind[bb::MAX_GROUPS];  // 0 block table, 1 quad table
  const uint8_t* tab[bb::MAX_GROUPS];
  int row_bytes[bb::MAX_GROUPS];
  int h[bb::MAX_GROUPS];
  int w[bb::MAX_GROUPS];
  int cpad[bb::MAX_GROUPS];
  int n_present[bb::MAX_GROUPS];
  int slot[bb::MAX_GROUPS][bb::N_SLOTS];
};

namespace bb {

// NaN-propagating clamps (torch.clamp semantics).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
__device__ __forceinline__ void normalize3(float* v) {
  const float inv = 1.f / clamp_min(sqrtf(dot3(v, v)), 1e-20f);
  v[0] = v[0] * inv;
  v[1] = v[1] * inv;
  v[2] = v[2] * inv;
}
__device__ __forceinline__ float tap(const uint8_t* row, int i) {
  return (float)row[i] * INV255;
}
// RGBA16F attachment round trip (round to nearest even).
__device__ __forceinline__ float q16(float x) {
  return __half2float(__float2half_rn(x));
}

// Bilinear footprint: REPEAT-wrapped top-left texel and the fractions.
__device__ __forceinline__ void footprint(float u, float v, int h, int w,
                                          int* x0i, int* y0i, float* tx,
                                          float* ty) {
  const float fx = u * (float)w - 0.5f;
  const float fy = v * (float)h - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  *tx = fx - x0;
  *ty = fy - y0;
  int xi = ((int)x0) % w;
  if (xi < 0) xi += w;
  int yi = ((int)y0) % h;
  if (yi < 0) yi += h;
  *x0i = xi;
  *y0i = yi;
}

// Block-table row of the 4x4 block holding texel (x0i, y0i): the 4 live
// taps of the 25 (the reference's dead taps add exact zeros), summed in the
// (j, i) row-major order, each weighted wx * wy. Writes n_out channels.
__device__ __forceinline__ void blend_block(const uint8_t* row, int lx,
                                            int ly, float tx, float ty,
                                            int cpad, int n_out, float* out) {
  const float omtx = 1.f - tx, omty = 1.f - ty;
  const int t00 = (ly * 5 + lx) * cpad, t01 = t00 + cpad;
  const int t10 = t00 + 5 * cpad, t11 = t10 + cpad;
  const float w00 = omtx * omty, w01 = tx * omty;
  const float w10 = omtx * ty, w11 = tx * ty;
  for (int k = 0; k < n_out; ++k) {
    float acc = tap(row, t00 + k) * w00;
    acc = acc + tap(row, t01 + k) * w01;
    acc = acc + tap(row, t10 + k) * w10;
    acc = acc + tap(row, t11 + k) * w11;
    out[k] = acc;
  }
}

// Quad-table row [t00 | t01 | t10 | t11] x cpad in the _blend order:
// top = q0*(1-tx) + q1*tx, bot likewise, then top*(1-ty) + bot*ty.
__device__ __forceinline__ float blend_quad(const uint8_t* row, int k,
                                            int cpad, float tx, float ty) {
  const float omtx = 1.f - tx, omty = 1.f - ty;
  const float top = tap(row, k) * omtx + tap(row, cpad + k) * tx;
  const float bot = tap(row, 2 * cpad + k) * omtx + tap(row, 3 * cpad + k) * tx;
  return top * omty + bot * ty;
}

// Bilinear samples of one size group into the slot array.
__device__ inline void sample_group(const ShadeGroups& g, int gi, float u,
                                    float v, float* slots) {
  const int h = g.h[gi], w = g.w[gi], cpad = g.cpad[gi];
  int x0i, y0i;
  float tx, ty;
  footprint(u, v, h, w, &x0i, &y0i, &tx, &ty);
  const int np = g.n_present[gi];
  if (g.kind[gi] == 0) {
    const int nbx = w / 4;
    const uint8_t* row =
        g.tab[gi] + (size_t)((y0i / 4) * nbx + (x0i / 4)) * g.row_bytes[gi];
    float acc[N_SLOTS];
    blend_block(row, x0i % 4, y0i % 4, tx, ty, cpad, np, acc);
    for (int k = 0; k < np; ++k) slots[g.slot[gi][k]] = acc[k];
  } else {
    const uint8_t* row =
        g.tab[gi] + (size_t)(y0i * w + x0i) * g.row_bytes[gi];
    for (int k = 0; k < np; ++k)
      slots[g.slot[gi][k]] = blend_quad(row, k, cpad, tx, ty);
  }
}

// The brdf.frag light loop (reference operation order) added into lo[3].
// With has_vis, the radiance of the light whose row has the visibility
// flag (column 13) is multiplied by vis.
__device__ inline void ggx_light_sum(const float* lp, int n_lights,
                                     bool has_vis, float vis,
                                     const float* world, const float* n3,
                                     const float* v3, const float* alb,
                                     const float* f0, float met, float rough,
                                     float* lo) {
  for (int li = 0; li < n_lights; ++li) {
    const float* L = lp + li * LIGHT_ROW;
    float to_l[3] = {L[0] - world[0], L[1] - world[1], L[2] - world[2]};
    const float d2 = clamp_min(dot3(to_l, to_l), 1e-20f);
    const float inv_d = 1.f / sqrtf(d2);
    const float l_point[3] = {to_l[0] * inv_d, to_l[1] * inv_d,
                              to_l[2] * inv_d};
    const float att_point = 1.f / d2;
    const float dlen =
        clamp_min(sqrtf(L[4] * L[4] + L[5] * L[5] + L[6] * L[6]), 1e-20f);
    const float dn[3] = {L[4] / dlen, L[5] / dlen, L[6] / dlen};
    const float theta = -(l_point[0] * dn[0] + l_point[1] * dn[1] +
                          l_point[2] * dn[2]);
    const float eps = L[11] - L[12];
    const float spot = clamp01((theta - L[12]) / (eps == 0.f ? 1.f : eps));
    const bool is_spot = L[3] == 1.f;
    const bool is_dir = L[3] == 2.f;
    float l_vec[3];
    for (int c = 0; c < 3; ++c) l_vec[c] = is_dir ? -dn[c] : l_point[c];
    const float att = is_dir ? 1.f : att_point * (is_spot ? spot : 1.f);

    float hv[3] = {l_vec[0] + v3[0], l_vec[1] + v3[1], l_vec[2] + v3[2]};
    normalize3(hv);
    const float a = rough * rough;
    const float a2 = a * a;
    const float ndh = clamp_min(dot3(n3, hv), 0.f);
    const float denom = ndh * ndh * (a2 - 1.f) + 1.f;
    const float d = a2 / (PI_F * denom * denom);
    const float hdv = clamp_min(dot3(hv, v3), 0.f);
    const float x = 1.f - hdv;
    const float x2 = x * x;
    const float fres = x * (x2 * x2);
    const float r1 = rough + 1.f;
    const float kk = (r1 * r1) / 8.f;
    const float ndv = clamp_min(dot3(n3, v3), 0.f);
    const float ndl = clamp_min(dot3(n3, l_vec), 0.f);
    const float gv =
        (ndv / (ndv * (1.f - kk) + kk)) * (ndl / (ndl * (1.f - kk) + kk));
    const float spec_den = 1.f / clamp_min(4.f * ndv * ndl, 0.001f);
    float radiance = att * L[7];
    if (has_vis && L[13] > 0.5f) radiance = radiance * vis;
    for (int c = 0; c < 3; ++c) {
      const float f = f0[c] + (1.f - f0[c]) * fres;
      const float specular = (d * f * gv) * spec_den;
      const float kd = (1.f - f) * (1.f - met);
      lo[c] = lo[c] + (kd * alb[c] / PI_F + specular) *
                          (radiance * L[8 + c]) * ndl;
    }
  }
}

}  // namespace bb
