// Device code shared by the sampled shade (K2, shade.cu), the G-buffer shade
// (K5, gbuffer_shade.cu) and the standalone samplers (K6 / K7, sample.cu;
// K8, mip_sample.cu): the bilinear footprint and texel blends of the
// material tables, pair-rate sampling's warp-group anchor (K2 and K6), the
// mip-block level and footprint geometry (K8) and trilinear blend, and the
// GGX light loop.
//
// Semantics are the reference's (bibim_tpu/ops/texture_quad.py _footprint,
// _blend, block_blend_acc, block_prep(pair_rows), mip_block_blend_acc;
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

template <int V>
struct IC {
  static constexpr int value = V;
};

// f(IC<B>{}), ..., f(IC<E - 1>{}): a loop whose index is a constant.
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(IC<B>{});
    static_for<B + 1, E>(f);
  }
}

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

// torch.remainder of int32 (the sign of the divisor, b > 0 here). A texel
// coordinate lies within one wrap of [0, b) unless uv leaves [-1, 2):
// those take no division.
__device__ __forceinline__ int floor_mod(int a, int b) {
  if ((unsigned)a < (unsigned)b) return a;
  if (a < 0 && a >= -b) return a + b;
  if (a >= b && a - b < b) return a - b;
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// Bilinear footprint: REPEAT-wrapped top-left texel and the fractions.
// FLOOR_MOD wraps with floor_mod: the integers of C's % and its fix-up,
// without the division in the common case (K2's per-pixel sampling keeps
// the division, and so its instructions).
template <bool FLOOR_MOD = false>
__device__ __forceinline__ void footprint(float u, float v, int h, int w,
                                          int* x0i, int* y0i, float* tx,
                                          float* ty) {
  const float fx = u * (float)w - 0.5f;
  const float fy = v * (float)h - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  *tx = fx - x0;
  *ty = fy - y0;
  if constexpr (FLOOR_MOD) {
    *x0i = floor_mod((int)x0, w);
    *y0i = floor_mod((int)y0, h);
  } else {
    int xi = ((int)x0) % w;
    if (xi < 0) xi += w;
    int yi = ((int)y0) % h;
    if (yi < 0) yi += h;
    *x0i = xi;
    *y0i = yi;
  }
}

// NW aligned 4-byte words from p (16-byte vectors where NW allows), through
// the read-only path.
template <int NW>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
    static_for<0, NW / 4>([&](auto q) {
      constexpr int Q = decltype(q)::value;
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + Q);
      w[4 * Q] = x.x;
      w[4 * Q + 1] = x.y;
      w[4 * Q + 2] = x.z;
      w[4 * Q + 3] = x.w;
    });
  } else if constexpr (NW == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_for<0, NW>([&](auto q) {
      w[decltype(q)::value] =
          __ldg(reinterpret_cast<const uint32_t*>(p) + decltype(q)::value);
    });
  }
}

// Byte B of a word array, as tap() converts it: byte * (1/255).
template <int B, int NW>
__device__ __forceinline__ float word_tap(const uint32_t (&w)[NW]) {
  return (float)((w[B >> 2] >> (8 * (B & 3))) & 0xffu) * INV255;
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

// Per-material table of a mip-block binding (texture_quad.mip_level_table),
// int32 words read 16 bytes at a time: MIP_HEAD words a material — level-0
// height and width (float bits), the last level, whether it has no stored
// parent — then MIP_LEVEL words a (material, level), nlev levels a
// material — height, width, first row, blocks a row, then height, width,
// half height and half width (each at least 1) as float bits.
constexpr int MIP_HEAD = 4, MIP_LEVEL = 8;
constexpr int MIP_B = 4;  // texels a block edge

// Pair-rate block sampling (texture_quad.pair_window, the reference's
// block_prep(pair_rows)): pixel i of an (NT, tile_h * tile_w) plane belongs
// to a group of 2 x RX pixels (rows r, r + 1 from an even r; at level 2
// columns c, c + 1 from an even c). The group anchors one 5x5 texel window
// at the min top-left tap of its covered members per axis (of all members
// where none is covered), and each pixel blends its own footprint relative
// to that window, its taps clamped to the window edge (tx / ty exactly 0 or
// 1 outside it, so the 4-live-tap blend keeps the 25-tap sum's bits).
//
// K2 and K6 hold a group in one warp. A warp covers 2 tile rows x 16
// columns: in each chunk of 2 * tile_w flat indices (one row pair of a
// tile; tile_w % 16 == 0) warp k of the chunk takes columns [16k, 16k + 16)
// of both rows. At level 2 lanes 4m .. 4m + 3 are 2x2 group m (lane bit 0
// the column, bit 1 the row); at level 1 lanes 2m, 2m + 1 are 2x1 group m
// (bit 0 the row). A warp's store to a plane is two runs of 16 adjacent
// pixels, 64 bytes each. pair_pixel is that permutation of each chunk:
// flat index f (warp aligned, so its low 5 bits are the lane) → the pixel
// its thread samples (RX 0, per-pixel sampling: f). The planes' pixel
// order does not change.
template <int RX>
__device__ __forceinline__ int pair_pixel(int f, int tile_w) {
  if constexpr (RX == 0) return f;
  const int c0 = f - f % (2 * tile_w);
  const int lane = f & 31;
  const int col = ((f - c0) >> 5 << 4) +
                  (RX == 2 ? ((lane >> 2) << 1 | (lane & 1)) : lane >> 1);
  const int row = RX == 2 ? (lane >> 1) & 1 : lane & 1;
  return c0 + row * tile_w + col;
}

// The group's anchor (xr, yr) from each lane's own top-left tap and
// coverage, reduced over the group's lanes (xor 1, and xor 2 at level 2):
// per axis the min over the covered members, or where none is covered
// the min over all members. A member's footprint is a function of its uv
// alone, so this is the anchor a thread would find from its group's
// planes itself, also from NaN uv at a miss. Every lane of the warp calls
// it (K6).
template <int RX>
__device__ __forceinline__ void group_anchor(int x0i, int y0i, bool cov,
                                             int* xr, int* yr) {
  constexpr int UNCOVERED = 1 << 30;  // above any texel coordinate
  int cx = cov ? x0i : UNCOVERED, cy = cov ? y0i : UNCOVERED;
  int ax = x0i, ay = y0i;
#pragma unroll
  for (int s = 1; s <= RX; s <<= 1) {
    cx = min(cx, __shfl_xor_sync(0xffffffffu, cx, s));
    cy = min(cy, __shfl_xor_sync(0xffffffffu, cy, s));
    ax = min(ax, __shfl_xor_sync(0xffffffffu, ax, s));
    ay = min(ay, __shfl_xor_sync(0xffffffffu, ay, s));
  }
  const bool any = cx != UNCOVERED;
  *xr = any ? cx : ax;
  *yr = any ? cy : ay;
}

// The anchor of a covered pixel's group where only the covered lanes call
// it (K2, which samples covered pixels alone; ``covered``: their warp
// mask, the same in every calling lane): per axis the min top-left tap
// over the group's members among them, each read straight from its lane
// (a missing member relays nothing, so no butterfly).
template <int RX>
__device__ __forceinline__ void covered_anchor(unsigned covered, int x0i,
                                               int y0i, int* xr, int* yr) {
  const int lane = threadIdx.x & 31;
  int cx = x0i, cy = y0i;
#pragma unroll
  for (int k = 1; k < 2 * RX; ++k) {  // lane ^ k: the group's other members
    const int ox = __shfl_sync(covered, x0i, lane ^ k);
    const int oy = __shfl_sync(covered, y0i, lane ^ k);
    if (covered >> (lane ^ k) & 1) {
      cx = min(cx, ox);
      cy = min(cy, oy);
    }
  }
  *xr = cx;
  *yr = cy;
}

// A block-table blend's inputs: the row, the tap in it and the fractions.
struct BlockTap {
  int r, lx, ly;
  float tx, ty;
};

// The pixel with top-left tap (x0i, y0i) and fractions (tx, ty) in the
// window of anchor (xr, yr) (both >= 0): the anchor's block row, the tap
// relative to it (REPEAT-wrapped into [-w/2, w/2)) clamped to the window,
// the fraction 0 or 1 outside it.
__device__ __forceinline__ BlockTap window_tap(int x0i, int y0i, float tx,
                                               float ty, int xr, int yr,
                                               int h, int w) {
  const int bx = (unsigned)xr / 4, by = (unsigned)yr / 4;
  const int cx = floor_mod(x0i - bx * 4 + w / 2, w) - w / 2;
  const int cy = floor_mod(y0i - by * 4 + h / 2, h) - h / 2;
  BlockTap t;
  t.r = by * (w / 4) + bx;
  t.lx = min(max(cx, 0), 3);
  t.ly = min(max(cy, 0), 3);
  t.tx = (cx < 0 || cx > 3) ? (cx < 0 ? 0.f : 1.f) : tx;
  t.ty = (cy < 0 || cy > 3) ? (cy < 0 ? 0.f : 1.f) : ty;
  return t;
}

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The level, blend fraction and footprint of one pixel in a mip-block
// binding, as texture_quad._mip_block_geometry computes them (operation
// for operation: quad_lod_planar, _level_select, _per_mat / _per_mat_level
// and the footprint), from its uv, material id and 2x2-quad differences
// (right - left, bottom - top); returns the block row index. An id outside
// [0, nmat) reads material 0's level-0 size, last level and parent flag,
// and height = width = 1, row 0, 1 block a row for the level. Int <->
// float conversions give 16 results a clock per SM against FP32's 128, so
// the table carries the sizes as floats too and floor-and-convert is one
// instruction; the texel coordinates, in [0, size) after the floor-mod,
// divide by MIP_B as unsigned (a shift).
__device__ __forceinline__ int mip_geometry(const int* mt, int nmat,
                                            int nlev, int mat, float u,
                                            float v, float du_dx,
                                            float dv_dx, float du_dy,
                                            float dv_dy, MipGeom* g) {
  const bool ok = mat >= 0 && mat < nmat;
  const int4 head =
      __ldg(reinterpret_cast<const int4*>(mt) + (ok ? mat : 0));
  const float h0 = __int_as_float(head.x), w0 = __int_as_float(head.y);
  const int max_level = head.z;
  const float ax = du_dx * w0, bx = dv_dx * h0;
  const float ay = du_dy * w0, by = dv_dy * h0;
  const float rho_x = sqrtf(ax * ax + bx * bx);
  const float rho_y = sqrtf(ay * ay + by * by);
  const float lod =
      clamp_min(log2f(clamp_min(nan_max(rho_x, rho_y), 1e-12f)), 0.f);
  const int l0 = min(max(__float2int_rd(lod), 0), max_level);
  g->frac = (l0 == max_level && head.w) ? 0.f : clamp01(lod - (float)l0);
  int4 li = make_int4(1, 1, 0, 1);
  float4 lf = make_float4(1.f, 1.f, 1.f, 1.f);
  if (ok) {
    const int4* lv = reinterpret_cast<const int4*>(mt + MIP_HEAD * nmat) +
                     2 * (mat * nlev + l0);
    li = __ldg(lv);
    const int4 b = __ldg(lv + 1);
    lf = make_float4(__int_as_float(b.x), __int_as_float(b.y),
                     __int_as_float(b.z), __int_as_float(b.w));
  }
  const int hi = li.x, wi = li.y;
  const float fx = u * lf.y - 0.5f, fy = v * lf.x - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  const int x0i = floor_mod((int)x0, wi), y0i = floor_mod((int)y0, hi);
  const int bxi = (unsigned)x0i / MIP_B, byi = (unsigned)y0i / MIP_B;
  const float fx2 = u * lf.w - 0.5f, fy2 = v * lf.z - 0.5f;
  const float x02 = floorf(fx2), y02 = floorf(fy2);
  g->lx = x0i - bxi * MIP_B;
  g->ly = y0i - byi * MIP_B;
  g->tx = fx - x0;
  g->ty = fy - y0;
  g->pxi = floor_mod((int)x02 - (2 * bxi - 1), max(wi / 2, 1));
  g->pyi = floor_mod((int)y02 - (2 * byi - 1), max(hi / 2, 1));
  g->tx2 = fx2 - x02;
  g->ty2 = fy2 - y02;
  return li.z + byi * li.w + bxi;
}

// Tap offsets and weights of the 41-tap trilinear blend at one pixel. Row
// layout: 5x5 child taps then 4x4 parent taps, tap-major, channel stride cs.
struct MipTaps {
  int c00, p00;  // the first child and the first parent tap
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
  t.frac = g.frac;
  t.omfr = 1.f - g.frac;
  return t;
}

// Channel k of the blend on its 8 live taps, read from the row through
// the read-only path. Child taps add in the w00/w01/w10/w11 (row-major)
// order of the 25-tap sum, whose 21 dead taps add exact zeros; parent
// taps likewise (a tap outside the stored 4x4 window is not in the sum);
// then own*(1-frac) + par*frac. The child taps lie at c00 + {0, 1, 5, 6}
// cs and the parent taps at p00 + {0, 1, 4, 5} cs: two addresses, the
// rest offsets (with cs a compile-time constant, immediate ones).
__device__ __forceinline__ float mip_channel(const uint8_t* row, int cs,
                                             const MipTaps& t, int k) {
  const uint8_t* ch = row + t.c00 + k;
  const uint8_t* pa = row + t.p00 + k;
  auto ld = [](const uint8_t* p) { return (float)__ldg(p) * INV255; };
  float own = ld(ch) * t.w00;
  own = own + ld(ch + cs) * t.w01;
  own = own + ld(ch + 5 * cs) * t.w10;
  own = own + ld(ch + 6 * cs) * t.w11;
  float par = (t.x0 && t.y0) ? ld(pa) * t.v00 : 0.f;
  par = par + ((t.x1 && t.y0) ? ld(pa + cs) * t.v01 : 0.f);
  par = par + ((t.x0 && t.y1) ? ld(pa + 4 * cs) * t.v10 : 0.f);
  par = par + ((t.x1 && t.y1) ? ld(pa + 5 * cs) * t.v11 : 0.f);
  return own * t.omfr + par * t.frac;
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
