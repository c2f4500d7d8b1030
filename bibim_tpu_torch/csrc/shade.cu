// K2 — fused sampled shade: material sampling + normal map + fp16 G-buffer
// + GGX lighting, one thread per pixel.
//
// Replaces bibim_tpu/ops/shading_pallas.py:_sampled_kernel (launched by
// shade_sampled_pallas) together with the XLA-side block_prep / small_prep
// that feed it at pair level 0.
//
// What bounds it on an H100: memory. Per pixel it reads 11 float planes
// and one byte of coverage (plus the shadow visibility plane when given),
// one 128-byte block-table row (the 2048^2 maps) and one 16-byte quad-table
// row (the 16^2 maps), and writes 3 floats — about 200 bytes, against ~400
// flops of light loop for 3 lights. The TPU version materialises the
// gathered block rows transposed to (NT, 128, NPX) through device memory
// (~265 MB at 1080p) because Mosaic cannot gather per pixel; here each
// thread reads its row by index ((y0/4)*nbx + x0/4) straight from the
// table, and the one-hot MXU select of the small table becomes a direct
// 16-byte row read (shading.cuh sample_group). Trilinear mip bindings
// (config 2) add two group kinds fed by per-pixel planes computed as torch
// ops: the mip-block row with the 41-tap blend K8 runs (40 more bytes of
// geometry per pixel) and material-routed small-table rows (12 bytes).
// Tone mapping stays outside (torch ops), as in the reference.
#include "shading.cuh"

namespace bb {

__global__ void __launch_bounds__(256)
shade_kernel(ShadeGroups g, const float* __restrict__ u,
             const float* __restrict__ v, const float* __restrict__ wx,
             const float* __restrict__ wy, const float* __restrict__ wz,
             const float* __restrict__ nx, const float* __restrict__ ny,
             const float* __restrict__ nz, const float* __restrict__ tgx,
             const float* __restrict__ tgy, const float* __restrict__ tgz,
             const uint8_t* __restrict__ valid,
             const float* __restrict__ vis_plane,
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
  for (int gi = 0; gi < g.n; ++gi) sample_group(g, gi, i, n, uu, vv, slots);

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
    if (quantize) x = q16(x);
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
  const bool has_vis = vis_plane != nullptr;
  ggx_light_sum(lp, n_lights, has_vis, has_vis ? vis_plane[i] : 1.f, world,
                n3, v3, alb, f0, met, rough, lo);
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
                        const uint8_t* valid, const float* vis_plane,
                        const float* lparams, int n_lights,
                        const float* view_pos, const int* nm_enable,
                        int gbuffer_mode, int quantize, int n, float* out_r,
                        float* out_g, float* out_b, void* stream) {
  if (n > 0) {
    const int threads = 256;
    bb::shade_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        *g, u, v, wx, wy, wz, nx, ny, nz, tgx, tgy, tgz, valid, vis_plane,
        lparams, n_lights, view_pos, nm_enable, gbuffer_mode, quantize, n,
        out_r, out_g, out_b);
  }
  return (int)cudaGetLastError();
}
