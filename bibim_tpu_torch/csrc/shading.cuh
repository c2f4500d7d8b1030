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

// Tap offsets and weights of the 41-tap trilinear blend at one pixel. Row
// layout: 5x5 child taps then 4x4 parent taps, tap-major, channel stride cs.
struct MipTaps {
  int c00, c01, c10, c11, p00, p01, p10, p11;
  float w00, w01, w10, w11, v00, v01, v10, v11, frac, omfr;
  bool x0, x1, y0, y1;
};

__device__ __forceinline__ MipTaps mip_taps(int cs, const MipGeom& g) {
  MipTaps t;
  const float omtx = 1.f - g.tx, omty = 1.f - g.ty;
  t.w00 = omtx * omty;
  t.w01 = g.tx * omty;
  t.w10 = omtx * g.ty;
  t.w11 = g.tx * g.ty;
  t.c00 = (g.ly * 5 + g.lx) * cs;
  t.c01 = t.c00 + cs;
  t.c10 = t.c00 + 5 * cs;
  t.c11 = t.c10 + cs;
  const float omtx2 = 1.f - g.tx2, omty2 = 1.f - g.ty2;
  t.v00 = omtx2 * omty2;
  t.v01 = g.tx2 * omty2;
  t.v10 = omtx2 * g.ty2;
  t.v11 = g.tx2 * g.ty2;
  t.x0 = g.pxi < 4;
  t.x1 = g.pxi + 1 < 4;
  t.y0 = g.pyi < 4;
  t.y1 = g.pyi + 1 < 4;
  t.p00 = (25 + g.pyi * 4 + g.pxi) * cs;
  t.p01 = t.p00 + cs;
  t.p10 = t.p00 + 4 * cs;
  t.p11 = t.p10 + cs;
  t.frac = g.frac;
  t.omfr = 1.f - g.frac;
  return t;
}

// Channel k of the blend on its 8 live taps. Child taps add in the
// w00/w01/w10/w11 (row-major) order of the 25-tap sum, whose 21 dead taps
// add exact zeros; parent taps likewise (a tap outside the stored 4x4
// window is not in the sum); then own*(1-frac) + par*frac.
__device__ __forceinline__ float mip_channel(const uint8_t* row,
                                             const MipTaps& t, int k) {
  float own = tap(row, t.c00 + k) * t.w00;
  own = own + tap(row, t.c01 + k) * t.w01;
  own = own + tap(row, t.c10 + k) * t.w10;
  own = own + tap(row, t.c11 + k) * t.w11;
  float par = (t.x0 && t.y0) ? tap(row, t.p00 + k) * t.v00 : 0.f;
  par = par + ((t.x1 && t.y0) ? tap(row, t.p01 + k) * t.v01 : 0.f);
  par = par + ((t.x0 && t.y1) ? tap(row, t.p10 + k) * t.v10 : 0.f);
  par = par + ((t.x1 && t.y1) ? tap(row, t.p11 + k) * t.v11 : 0.f);
  return own * t.omfr + par * t.frac;
}

// The 41-tap trilinear blend of n_out channels (K8).
__device__ inline void mip_block_blend(const uint8_t* row, int cs,
                                       const MipGeom& g, int n_out,
                                       float* out) {
  const MipTaps t = mip_taps(cs, g);
  for (int k = 0; k < n_out; ++k) out[k] = mip_channel(row, t, k);
}

// ---------------------------------------------------------------------------
// The GGX light loop of K2 and K5 (bibim_tpu/ops/shading_pallas.py
// _ggx_light_sum, brdf.frag operation order), split in two: what depends
// only on a light is computed by the block into a shared-memory tile of
// LIGHT_TILE lights (prepare_light / stage_lights), the per-pixel loop
// reads it (ggx_lights). Both halves are the reference's expressions on the
// same inputs, so the sum is bit for bit what one fused loop gives. A
// light list that fits the tile is staged once per block, and the kernels
// then run a pixel loop with no barrier in it; a longer one passes through
// the tile in order, once per pixel step (for_light_tiles), so any number
// of lights adds into lo in the reference's order.
// ---------------------------------------------------------------------------

constexpr int LIGHT_TILE = 64;  // 4 KB of prepared lights a block

enum LightKind : int { LIGHT_POINT = 0, LIGHT_SPOT = 1, LIGHT_DIR = 2 };

struct alignas(16) PreparedLight {
  float pos[3];
  float dn[3];      // dir / max(|dir|, 1e-20)
  float outer;      // outer cutoff
  float eps_div;    // inner - outer, or 1 where that is 0
  float intensity;
  float color[3];
  int kind;         // LightKind (a type other than 1 or 2 lights as a point)
  int vis;          // the visibility flag (column 13 > 0.5)
};
static_assert(sizeof(PreparedLight) == 64, "PreparedLight is 4 x 16 bytes");

// One packed row (scene/lights.py pack_lights) → its invariants.
__device__ __forceinline__ void prepare_light(const float* L,
                                              PreparedLight* p) {
  const float dlen =
      clamp_min(sqrtf(L[4] * L[4] + L[5] * L[5] + L[6] * L[6]), 1e-20f);
  for (int c = 0; c < 3; ++c) {
    p->pos[c] = L[c];
    p->dn[c] = L[4 + c] / dlen;
    p->color[c] = L[8 + c];
  }
  const float eps = L[11] - L[12];
  p->outer = L[12];
  p->eps_div = eps == 0.f ? 1.f : eps;
  p->intensity = L[7];
  p->kind = L[3] == 2.f ? LIGHT_DIR : (L[3] == 1.f ? LIGHT_SPOT : LIGHT_POINT);
  p->vis = L[13] > 0.5f;
}

// The block's first warp prepares lights [0, n) of ``lp`` (n <= LIGHT_TILE)
// into the tile, then the block synchronises.
__device__ __forceinline__ void stage_lights(const float* __restrict__ lp,
                                             int n, PreparedLight* tile) {
  if (threadIdx.x < 32)
    for (int li = threadIdx.x; li < n; li += 32)
      prepare_light(lp + li * LIGHT_ROW, tile + li);
  __syncthreads();
}

// f(tile, count) for the lights in order, one tile at a time. RESIDENT: the
// list fits the tile and was staged at kernel entry. Otherwise it is
// restaged tile by tile: every thread of the block calls this with the
// same n_lights, as it synchronises.
template <bool RESIDENT, class F>
__device__ __forceinline__ void for_light_tiles(const float* lp,
                                                int n_lights,
                                                PreparedLight* tile, F&& f) {
  if constexpr (RESIDENT) {
    f(tile, n_lights);
  } else {
    for (int l0 = 0; l0 < n_lights; l0 += LIGHT_TILE) {
      const int count = min(LIGHT_TILE, n_lights - l0);
      __syncthreads();  // every thread is done with the previous tile
      stage_lights(lp + (size_t)l0 * LIGHT_ROW, count, tile);
      f(tile, count);
    }
  }
}

// A covered pixel's inputs to the light loop: position, unit normal and
// view vector, albedo, F0, metallic, roughness and the visibility of the
// flagged light.
struct Surface {
  float world[3], n[3], v[3], alb[3], f0[3];
  float met, rough, vis;
};

// The terms of the light loop that do not depend on the light.
struct GgxTerms {
  float a2, a2m1, kk, omkk, gv_v, ndv4, om_met, om_f0[3];
};

__device__ __forceinline__ GgxTerms ggx_terms(const Surface& s) {
  GgxTerms t;
  const float a = s.rough * s.rough;
  t.a2 = a * a;
  t.a2m1 = t.a2 - 1.f;
  const float r1 = s.rough + 1.f;
  t.kk = (r1 * r1) / 8.f;
  t.omkk = 1.f - t.kk;
  const float ndv = clamp_min(dot3(s.n, s.v), 0.f);
  t.gv_v = ndv / (ndv * t.omkk + t.kk);
  t.ndv4 = 4.f * ndv;
  t.om_met = 1.f - s.met;
  for (int c = 0; c < 3; ++c) t.om_f0[c] = 1.f - s.f0[c];
  return t;
}

// One light's term at one pixel, added into lo[3]. With has_vis, the
// radiance of the light with the visibility flag is multiplied by s.vis.
// A directional light skips the point-light terms and a point light the
// spot term, whose results the reference selects away.
__device__ __forceinline__ void ggx_light(const PreparedLight& L,
                                          bool has_vis, const Surface& s,
                                          const GgxTerms& t, float* lo) {
  const float *world = s.world, *n3 = s.n, *v3 = s.v;
  float l_vec[3], att;
  if (L.kind == LIGHT_DIR) {
    for (int c = 0; c < 3; ++c) l_vec[c] = -L.dn[c];
    att = 1.f;
  } else {
    const float to_l[3] = {L.pos[0] - world[0], L.pos[1] - world[1],
                           L.pos[2] - world[2]};
    const float d2 = clamp_min(dot3(to_l, to_l), 1e-20f);
    const float inv_d = 1.f / sqrtf(d2);
    for (int c = 0; c < 3; ++c) l_vec[c] = to_l[c] * inv_d;
    att = 1.f / d2;
    if (L.kind == LIGHT_SPOT) {
      const float theta = -(l_vec[0] * L.dn[0] + l_vec[1] * L.dn[1] +
                            l_vec[2] * L.dn[2]);
      att = att * clamp01((theta - L.outer) / L.eps_div);
    }
  }
  float hv[3] = {l_vec[0] + v3[0], l_vec[1] + v3[1], l_vec[2] + v3[2]};
  normalize3(hv);
  const float ndh = clamp_min(dot3(n3, hv), 0.f);
  const float denom = ndh * ndh * t.a2m1 + 1.f;
  const float d = t.a2 / (PI_F * denom * denom);
  const float hdv = clamp_min(dot3(hv, v3), 0.f);
  const float x = 1.f - hdv;
  const float x2 = x * x;
  const float fres = x * (x2 * x2);
  const float ndl = clamp_min(dot3(n3, l_vec), 0.f);
  const float gv = t.gv_v * (ndl / (ndl * t.omkk + t.kk));
  const float spec_den = 1.f / clamp_min(t.ndv4 * ndl, 0.001f);
  float radiance = att * L.intensity;
  if (has_vis && L.vis) radiance = radiance * s.vis;
  for (int c = 0; c < 3; ++c) {
    const float f = s.f0[c] + t.om_f0[c] * fres;
    const float specular = (d * f * gv) * spec_den;
    const float kd = (1.f - f) * t.om_met;
    lo[c] = lo[c] + (kd * s.alb[c] / PI_F + specular) *
                        (radiance * L.color[c]) * ndl;
  }
}

// The light loop at one pixel over n_lights prepared lights, added into
// lo[3]; the light-independent terms once per call (once per tile where
// the lights pass through the tile).
__device__ __forceinline__ void ggx_lights(const PreparedLight* lights,
                                           int n_lights, bool has_vis,
                                           const Surface& s, float* lo) {
  const GgxTerms t = ggx_terms(s);
  for (int li = 0; li < n_lights; ++li)
    ggx_light(lights[li], has_vis, s, t, lo);
}

// The frame's tail after a shading kernel, fused (options of K2 and K5):
// the RGBA16F round trip of the HDR result, then the exposure tone map
// 1 - exp(-hdr * exposure) (ops/tonemap.py tone_map).
__device__ __forceinline__ float hdr_epilogue(float hdr, bool quantize,
                                              bool tonemap, float exposure) {
  if (quantize) hdr = q16(hdr);
  return tonemap ? 1.f - expf(-hdr * exposure) : hdr;
}

// Blocks of a grid-stride launch: one resident wave of the kernel (its
// occupancy at ``threads`` per block, looked up once per device into the
// caller's ``wave``), and no more than the pixels need, so each block
// prepares its lights once for many pixels.
constexpr int MAX_DEVICES = 64;
template <class K>
inline int resident_grid(K kernel, int threads, int n,
                         int (&wave)[MAX_DEVICES]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& full = wave[dev % MAX_DEVICES];
  if (full == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    full = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const int need = (n + threads - 1) / threads;
  return need < full ? need : full;
}

}  // namespace bb
