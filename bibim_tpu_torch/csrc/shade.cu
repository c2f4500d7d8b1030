// K2 — fused sampled shade: material sampling + normal map + fp16 G-buffer
// + GGX lighting, one thread per pixel.
//
// Replaces bibim_tpu/ops/shading_pallas.py:_sampled_kernel (launched by
// shade_sampled_pallas) together with the XLA-side block_prep / small_prep
// that feed it at pair level 0.
//
// What bounds it on an H100: memory. Per pixel it reads 11 float planes
// and one byte of coverage, one 128-byte block-table row (the 2048^2 maps)
// and one 16-byte quad-table row (the 16^2 maps), and writes 3 floats —
// about 200 bytes, against ~400 flops of light loop for 3 lights. The TPU
// version materialises the gathered block rows transposed to (NT, 128, NPX)
// through device memory (~265 MB at 1080p) because Mosaic cannot gather
// per pixel; here each thread reads its row by index
// ((y0/4)*nbx + x0/4) straight from the table, and the one-hot MXU select
// of the small table becomes a direct 16-byte row read. Of the 25 taps of a
// block row only the 4 live ones are read: the reference's dead taps add
// exact zeros, so the (j, i) row-major sum of the live taps is bit-equal.
// Tone mapping stays outside (torch ops), as in the reference.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bb {

constexpr int MAX_GROUPS = 4;
constexpr int N_SLOTS = 10;  // alb_rgb, nrm_xyz, metallic, roughness, ao, height
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

// Bilinear samples of one size group into the slot array.
__device__ inline void sample_group(const ShadeGroups& g, int gi, float u,
                                    float v, float* slots) {
  const int h = g.h[gi], w = g.w[gi], cpad = g.cpad[gi];
  const float fx = u * (float)w - 0.5f;
  const float fy = v * (float)h - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = fx - x0, ty = fy - y0;
  int x0i = ((int)x0) % w;
  if (x0i < 0) x0i += w;
  int y0i = ((int)y0) % h;
  if (y0i < 0) y0i += h;
  const float omtx = 1.f - tx, omty = 1.f - ty;
  const int np = g.n_present[gi];
  if (g.kind[gi] == 0) {
    // Block table: row of the 4x4 block holding the top-left tap; taps
    // (j, i) row-major, the 4 live ones at (ly|ly+1, lx|lx+1).
    const int nbx = w / 4;
    const uint8_t* row =
        g.tab[gi] + (size_t)((y0i / 4) * nbx + (x0i / 4)) * g.row_bytes[gi];
    const int lx = x0i % 4, ly = y0i % 4;
    const int t00 = (ly * 5 + lx) * cpad, t01 = t00 + cpad;
    const int t10 = t00 + 5 * cpad, t11 = t10 + cpad;
    const float w00 = omtx * omty, w01 = tx * omty;
    const float w10 = omtx * ty, w11 = tx * ty;
    for (int k = 0; k < np; ++k) {
      float acc = tap(row, t00 + k) * w00;
      acc = acc + tap(row, t01 + k) * w01;
      acc = acc + tap(row, t10 + k) * w10;
      acc = acc + tap(row, t11 + k) * w11;
      slots[g.slot[gi][k]] = acc;
    }
  } else {
    // Quad table: [t00 | t01 | t10 | t11] x cpad per texel row.
    const uint8_t* row =
        g.tab[gi] + (size_t)(y0i * w + x0i) * g.row_bytes[gi];
    for (int k = 0; k < np; ++k) {
      const float top = tap(row, k) * omtx + tap(row, cpad + k) * tx;
      const float bot = tap(row, 2 * cpad + k) * omtx +
                        tap(row, 3 * cpad + k) * tx;
      slots[g.slot[gi][k]] = top * omty + bot * ty;
    }
  }
}

__global__ void __launch_bounds__(256)
shade_kernel(ShadeGroups g, const float* __restrict__ u,
             const float* __restrict__ v, const float* __restrict__ wx,
             const float* __restrict__ wy, const float* __restrict__ wz,
             const float* __restrict__ nx, const float* __restrict__ ny,
             const float* __restrict__ nz, const float* __restrict__ tgx,
             const float* __restrict__ tgy, const float* __restrict__ tgz,
             const uint8_t* __restrict__ valid,
             const float* __restrict__ lp, int n_lights,
             const float* __restrict__ view_pos,
             const int* __restrict__ nm_enable, int gbuffer_mode,
             int quantize, int n, float* __restrict__ out_r,
             float* __restrict__ out_g, float* __restrict__ out_b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float slots[N_SLOTS];
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) slots[k] = 0.f;
  const float uu = u[i], vv = v[i];
  for (int gi = 0; gi < g.n; ++gi) sample_group(g, gi, uu, vv, slots);

  // Normal map (gbuffer.frag): N = TBN * (2*tap - 1), B = cross(N, T).
  const float nrm[3] = {nx[i], ny[i], nz[i]};
  const float tan[3] = {tgx[i], tgy[i], tgz[i]};
  const float bit[3] = {nrm[1] * tan[2] - nrm[2] * tan[1],
                        nrm[2] * tan[0] - nrm[0] * tan[2],
                        nrm[0] * tan[1] - nrm[1] * tan[0]};
  const float mx = slots[3] * 2.f - 1.f;
  const float my = slots[4] * 2.f - 1.f;
  const float mz = slots[5] * 2.f - 1.f;
  const bool nm_on = *nm_enable != 0;
  const bool is_valid = valid[i] != 0;

  // Deferred G-buffer: miss pixels cleared, then the RGBA16F round trip.
  auto mq = [&](float x) {
    if (gbuffer_mode && !is_valid) x = 0.f;
    if (quantize) x = __half2float(__float2half_rn(x));
    return x;
  };
  const float world[3] = {mq(wx[i]), mq(wy[i]), mq(wz[i])};
  float n3[3], alb[3];
  for (int c = 0; c < 3; ++c) {
    const float mapped = tan[c] * mx + bit[c] * my + nrm[c] * mz;
    n3[c] = mq(nm_on ? mapped : nrm[c]);
    alb[c] = mq(slots[c]);
  }
  const float met = mq(slots[6]), rough = mq(slots[7]), ao = mq(slots[8]);
  normalize3(n3);
  float v3[3] = {view_pos[0] - world[0], view_pos[1] - world[1],
                 view_pos[2] - world[2]};
  normalize3(v3);
  float f0[3], lo[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < 3; ++c) f0[c] = 0.04f * (1.f - met) + alb[c] * met;

  // GGX light loop (brdf.frag / brdf.glsl), reference operation order.
  for (int li = 0; li < n_lights; ++li) {
    const float* L = lp + li * 16;
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
    const float radiance = att * L[7];
    for (int c = 0; c < 3; ++c) {
      const float f = f0[c] + (1.f - f0[c]) * fres;
      const float specular = (d * f * gv) * spec_den;
      const float kd = (1.f - f) * (1.f - met);
      lo[c] = lo[c] + (kd * alb[c] / PI_F + specular) *
                          (radiance * L[8 + c]) * ndl;
    }
  }
  float hdr[3];
  for (int c = 0; c < 3; ++c) {
    hdr[c] = is_valid ? 0.03f * alb[c] * ao + lo[c] : 0.f;
  }
  out_r[i] = hdr[0];
  out_g[i] = hdr[1];
  out_b[i] = hdr[2];
}

}  // namespace bb

extern "C" int bb_shade(const ShadeGroups* g, const float* u, const float* v,
                        const float* wx, const float* wy, const float* wz,
                        const float* nx, const float* ny, const float* nz,
                        const float* tgx, const float* tgy, const float* tgz,
                        const uint8_t* valid, const float* lparams,
                        int n_lights, const float* view_pos,
                        const int* nm_enable, int gbuffer_mode, int quantize,
                        int n, float* out_r, float* out_g, float* out_b,
                        void* stream) {
  if (n > 0) {
    const int threads = 256;
    bb::shade_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        *g, u, v, wx, wy, wz, nx, ny, nz, tgx, tgy, tgz, valid, lparams,
        n_lights, view_pos, nm_enable, gbuffer_mode, quantize, n, out_r,
        out_g, out_b);
  }
  return (int)cudaGetLastError();
}
