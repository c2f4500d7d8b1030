// Device code shared by the sampled shade (K2, shade.cu), the G-buffer shade
// (K5, gbuffer_shade.cu) and the standalone samplers (K6 / K7, sample.cu;
// K8, mip_sample.cu): the bilinear footprint and texel blends of the
// material tables, the trilinear mip-block blend, and the GGX light loop.
//
// Semantics are the reference's (bibim_tpu/ops/texture_quad.py _footprint,
// _blend, block_blend_acc, mip_block_blend_acc;
// bibim_tpu/ops/shading_pallas.py _ggx_light_sum), operation for operation.
// The library is compiled with -fmad=false, so every a*b+c rounds the
// product and the sum separately, as the plain PyTorch versions do.
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

// Mirror of bibim_tpu_torch._build.Groups. Kinds: 0 block table and 1 quad
// table (footprint from u, v in the kernel); 2 mip-block table (per-pixel
// geometry planes gi = idx, lx, ly, pxi, pyi and gf = tx, ty, tx2, ty2,
// frac, texture_quad._mip_block_geometry); 3 material-routed quad rows
// (gi = row index, gf = tx, ty). Plane k of gi/gf starts at k * n.
struct ShadeGroups {
  int n;
  int kind[bb::MAX_GROUPS];
  const uint8_t* tab[bb::MAX_GROUPS];
  int rows[bb::MAX_GROUPS];
  int row_bytes[bb::MAX_GROUPS];
  int h[bb::MAX_GROUPS];
  int w[bb::MAX_GROUPS];
  int cpad[bb::MAX_GROUPS];  // channel stride (len(present) for kind 2)
  int n_present[bb::MAX_GROUPS];
  int slot[bb::MAX_GROUPS][bb::N_SLOTS];
  const int* gi[bb::MAX_GROUPS];
  const float* gf[bb::MAX_GROUPS];
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

// Footprint of one pixel in a mip-block row (texture_quad._mip_block_geometry).
struct MipGeom {
  int lx, ly, pxi, pyi;
  float tx, ty, tx2, ty2, frac;
};

// Pixel i of the (5, n) geometry stacks (texture_quad.mip_geometry_planes);
// returns the block row index.
__device__ __forceinline__ int load_mip_geom(const int* gi, const float* gf,
                                             int i, int n, MipGeom* g) {
  g->lx = gi[n + i];
  g->ly = gi[2 * n + i];
  g->pxi = gi[3 * n + i];
  g->pyi = gi[4 * n + i];
  g->tx = gf[i];
  g->ty = gf[n + i];
  g->tx2 = gf[2 * n + i];
  g->ty2 = gf[3 * n + i];
  g->frac = gf[4 * n + i];
  return gi[i];
}

// The 41-tap trilinear blend on its 8 live taps. Row layout: 5x5 child taps
// then 4x4 parent taps, tap-major, channel stride cs. Child taps add in the
// w00/w01/w10/w11 (row-major) order of the 25-tap sum, whose 21 dead taps
// add exact zeros; parent taps likewise (a tap outside the stored 4x4
// window is not in the sum); then own*(1-frac) + par*frac.
__device__ inline void mip_block_blend(const uint8_t* row, int cs,
                                       const MipGeom& g, int n_out,
                                       float* out) {
  const float omtx = 1.f - g.tx, omty = 1.f - g.ty;
  const float w00 = omtx * omty, w01 = g.tx * omty;
  const float w10 = omtx * g.ty, w11 = g.tx * g.ty;
  const int c00 = (g.ly * 5 + g.lx) * cs, c01 = c00 + cs;
  const int c10 = c00 + 5 * cs, c11 = c10 + cs;
  const float omtx2 = 1.f - g.tx2, omty2 = 1.f - g.ty2;
  const float v00 = omtx2 * omty2, v01 = g.tx2 * omty2;
  const float v10 = omtx2 * g.ty2, v11 = g.tx2 * g.ty2;
  const bool x0 = g.pxi < 4, x1 = g.pxi + 1 < 4;
  const bool y0 = g.pyi < 4, y1 = g.pyi + 1 < 4;
  const int p00 = (25 + g.pyi * 4 + g.pxi) * cs, p01 = p00 + cs;
  const int p10 = p00 + 4 * cs, p11 = p10 + cs;
  const float omfr = 1.f - g.frac;
  for (int k = 0; k < n_out; ++k) {
    float own = tap(row, c00 + k) * w00;
    own = own + tap(row, c01 + k) * w01;
    own = own + tap(row, c10 + k) * w10;
    own = own + tap(row, c11 + k) * w11;
    float par = (x0 && y0) ? tap(row, p00 + k) * v00 : 0.f;
    par = par + ((x1 && y0) ? tap(row, p01 + k) * v01 : 0.f);
    par = par + ((x0 && y1) ? tap(row, p10 + k) * v10 : 0.f);
    par = par + ((x1 && y1) ? tap(row, p11 + k) * v11 : 0.f);
    out[k] = own * omfr + par * g.frac;
  }
}

// Samples of one size group at pixel i (of n) into the slot array.
__device__ inline void sample_group(const ShadeGroups& g, int gi, int i,
                                    int n, float u, float v, float* slots) {
  const int np = g.n_present[gi], cpad = g.cpad[gi];
  if (g.kind[gi] == 2) {
    MipGeom geom;
    const int r = load_mip_geom(g.gi[gi], g.gf[gi], i, n, &geom);
    float acc[N_SLOTS];
    mip_block_blend(g.tab[gi] + (size_t)r * g.row_bytes[gi], cpad, geom, np,
                    acc);
    for (int k = 0; k < np; ++k) slots[g.slot[gi][k]] = acc[k];
    return;
  }
  if (g.kind[gi] == 3) {
    // A row outside the table samples 0 (the reference's one-hot select).
    const int r = g.gi[gi][i];
    const bool in = r >= 0 && r < g.rows[gi];
    const uint8_t* row = g.tab[gi] + (size_t)(in ? r : 0) * g.row_bytes[gi];
    const float tx = g.gf[gi][i], ty = g.gf[gi][n + i];
    for (int k = 0; k < np; ++k)
      slots[g.slot[gi][k]] = in ? blend_quad(row, k, cpad, tx, ty) : 0.f;
    return;
  }
  const int h = g.h[gi], w = g.w[gi];
  int x0i, y0i;
  float tx, ty;
  footprint(u, v, h, w, &x0i, &y0i, &tx, &ty);
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
