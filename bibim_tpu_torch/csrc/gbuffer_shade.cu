// K5 — deferred GGX shade of G-buffer planes, one thread per pixel, with
// the optional shadow visibility plane, IBL ambient planes, fp16 round trip
// and exposure tone map of the TPU kernel.
//
// Replaces bibim_tpu/ops/shading_pallas.py:_shade_kernel (launched by
// shade_tonemap_pallas). The frame calls it on the path the sampled shade
// (K2) cannot take — IBL ambient on (framegraph _pbr_ldr_fused) — with
// quantize and tonemap off; both stay options of the kernel.
//
// What bounds it on an H100: memory. Per pixel it reads 12 float planes
// and one byte of coverage, plus 1 visibility and 3 ambient planes when
// given (up to 65 bytes), and writes 3 floats, against ~130 flops per
// light. The TPU kernel batches 16-32 tiles per grid step to hide its
// per-step cost; here a flat grid of 256-thread blocks over all pixels
// reads each plane coalesced. The light loop is K2's (shading.cuh
// ggx_light_sum), so the two kernels light a pixel identically.
#include "shading.cuh"

namespace bb {

__global__ void __launch_bounds__(256)
gbuffer_shade_kernel(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ wz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const float* __restrict__ ar, const float* __restrict__ ag,
    const float* __restrict__ ab, const float* __restrict__ metallic,
    const float* __restrict__ roughness, const float* __restrict__ ao_p,
    const uint8_t* __restrict__ valid, const float* __restrict__ vis_plane,
    const float* __restrict__ amb_r, const float* __restrict__ amb_g,
    const float* __restrict__ amb_b, const float* __restrict__ lp,
    int n_lights, const float* __restrict__ view_pos,
    const float* __restrict__ exposure, const int* __restrict__ tm_enable,
    int quantize, int tonemap, int n, float* __restrict__ out_r,
    float* __restrict__ out_g, float* __restrict__ out_b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float world[3] = {wx[i], wy[i], wz[i]};
  float n3[3] = {nx[i], ny[i], nz[i]};
  normalize3(n3);
  float v3[3] = {view_pos[0] - world[0], view_pos[1] - world[1],
                 view_pos[2] - world[2]};
  normalize3(v3);
  const float alb[3] = {ar[i], ag[i], ab[i]};
  const float met = metallic[i], rough = roughness[i], ao = ao_p[i];
  float f0[3], lo[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < 3; ++c) f0[c] = 0.04f * (1.f - met) + alb[c] * met;
  const bool has_vis = vis_plane != nullptr;
  ggx_light_sum(lp, n_lights, has_vis, has_vis ? vis_plane[i] : 1.f, world,
                n3, v3, alb, f0, met, rough, lo);

  float amb[3];
  if (amb_r != nullptr) {
    amb[0] = amb_r[i];
    amb[1] = amb_g[i];
    amb[2] = amb_b[i];
  } else {
    for (int c = 0; c < 3; ++c) amb[c] = 0.03f * alb[c] * ao;
  }
  const bool is_valid = valid[i] != 0;
  const bool tm_on = tonemap && *tm_enable != 0;
  float out[3];
  for (int c = 0; c < 3; ++c) {
    float hdr = is_valid ? amb[c] + lo[c] : 0.f;
    if (quantize) hdr = q16(hdr);
    out[c] = tm_on ? 1.f - expf(-hdr * *exposure) : hdr;
  }
  out_r[i] = out[0];
  out_g[i] = out[1];
  out_b[i] = out[2];
}

}  // namespace bb

extern "C" int bb_shade_gbuffer(
    const float* wx, const float* wy, const float* wz, const float* nx,
    const float* ny, const float* nz, const float* ar, const float* ag,
    const float* ab, const float* metallic, const float* roughness,
    const float* ao, const uint8_t* valid, const float* vis_plane,
    const float* amb_r, const float* amb_g, const float* amb_b,
    const float* lparams, int n_lights, const float* view_pos,
    const float* exposure, const int* tm_enable, int quantize, int tonemap,
    int n, float* out_r, float* out_g, float* out_b, void* stream) {
  if (n > 0) {
    const int threads = 256;
    bb::gbuffer_shade_kernel<<<(n + threads - 1) / threads, threads, 0,
                               (cudaStream_t)stream>>>(
        wx, wy, wz, nx, ny, nz, ar, ag, ab, metallic, roughness, ao, valid,
        vis_plane, amb_r, amb_g, amb_b, lparams, n_lights, view_pos,
        exposure, tm_enable, quantize, tonemap, n, out_r, out_g, out_b);
  }
  return (int)cudaGetLastError();
}
