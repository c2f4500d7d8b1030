// K5 — deferred GGX shade of G-buffer planes, with the optional shadow
// visibility plane, IBL ambient planes, fp16 round trip and exposure tone
// map of the TPU kernel.
//
// Replaces bibim_tpu/ops/shading_pallas.py:_shade_kernel (launched by
// shade_tonemap_pallas). The frame calls it on the path the sampled shade
// (K2) cannot take — IBL ambient on (framegraph _pbr_ldr_fused) — and lets
// it write the LDR planes (quantize and tonemap on).
//
// What bounds it on an H100: bytes. Per valid pixel it reads 12 float
// planes and one byte of coverage, plus 1 visibility and 3 ambient planes
// when given (up to 65 bytes), and writes 3 floats, against a light loop
// of IEEE divisions and square roots (-fmad=false); it runs at about twice
// the time those bytes need. So, as in K2
// (shade.cu), nothing is spent that the output does not need: a miss reads
// its coverage byte only; the light rows are prepared by the block into a
// shared-memory tile (shading.cuh stage_lights, for_light_tiles) and the
// per-pixel loop skips the terms a light's type discards; a grid-stride
// loop over one resident wave of blocks amortises the preparation. The
// light loop is K2's (shading.cuh ggx_lights), so the two kernels light a
// pixel identically.
#include "shading.cuh"

namespace bb {

constexpr int GBUFFER_THREADS = 256;

struct GBufferArgs {
  const float *wx, *wy, *wz, *nx, *ny, *nz, *ar, *ag, *ab, *metallic,
      *roughness, *ao;
  const uint8_t* valid;  // the bool plane's bytes
  const float* vis_plane;  // or NULL
  const float *amb_r, *amb_g, *amb_b;  // or NULL
  const float* lp;  // (max(L, 1), 16) light rows
  int n_lights;
  const float* view_pos;
  const float* exposure;
  const int* tm_enable;
  int quantize, tonemap;
  int n;
  float *out_r, *out_g, *out_b;
};

// The block's pixels, grid-stride; RESIDENT: the lights fit the tile and
// are staged (for_light_tiles).
template <bool RESIDENT>
__device__ __forceinline__ void shade_gbuffer_pixels(const GBufferArgs& a,
                                                     PreparedLight* tile) {
  const float vp[3] = {a.view_pos[0], a.view_pos[1], a.view_pos[2]};
  const bool tm_on = a.tonemap && *a.tm_enable != 0;
  const float expo = tm_on ? *a.exposure : 0.f;
  const bool quant = a.quantize != 0;
  const bool has_vis = a.vis_plane != nullptr;
  const bool has_amb = a.amb_r != nullptr;
  const float miss = hdr_epilogue(0.f, quant, tm_on, expo);
  const int stride = gridDim.x * blockDim.x;
  // The trip count is the block's, not the thread's: for_light_tiles may
  // synchronise the block.
  for (int base = blockIdx.x * blockDim.x; base < a.n; base += stride) {
    const int i = base + threadIdx.x;
    const bool hit = i < a.n && a.valid[i] != 0;
    Surface s;
    if (hit) {
      s.world[0] = a.wx[i];
      s.world[1] = a.wy[i];
      s.world[2] = a.wz[i];
      s.n[0] = a.nx[i];
      s.n[1] = a.ny[i];
      s.n[2] = a.nz[i];
      normalize3(s.n);
      for (int c = 0; c < 3; ++c) s.v[c] = vp[c] - s.world[c];
      normalize3(s.v);
      s.alb[0] = a.ar[i];
      s.alb[1] = a.ag[i];
      s.alb[2] = a.ab[i];
      s.met = a.metallic[i];
      s.rough = a.roughness[i];
      for (int c = 0; c < 3; ++c)
        s.f0[c] = 0.04f * (1.f - s.met) + s.alb[c] * s.met;
      s.vis = has_vis ? a.vis_plane[i] : 1.f;
    }
    float lo[3] = {0.f, 0.f, 0.f};
    for_light_tiles<RESIDENT>(a.lp, a.n_lights, tile,
                              [&](const PreparedLight* lights, int count) {
                                if (hit)
                                  ggx_lights(lights, count, has_vis, s, lo);
                              });
    if (!hit) {
      if (i < a.n) {
        a.out_r[i] = miss;
        a.out_g[i] = miss;
        a.out_b[i] = miss;
      }
      continue;
    }
    float amb[3];
    if (has_amb) {
      amb[0] = a.amb_r[i];
      amb[1] = a.amb_g[i];
      amb[2] = a.amb_b[i];
    } else {
      const float ao = a.ao[i];
      for (int c = 0; c < 3; ++c) amb[c] = 0.03f * s.alb[c] * ao;
    }
    a.out_r[i] = hdr_epilogue(amb[0] + lo[0], quant, tm_on, expo);
    a.out_g[i] = hdr_epilogue(amb[1] + lo[1], quant, tm_on, expo);
    a.out_b[i] = hdr_epilogue(amb[2] + lo[2], quant, tm_on, expo);
  }
}

// RESIDENT and the tiled light path are separate kernels, so that neither's
// registers constrain the other.
template <bool RESIDENT>
__global__ void __launch_bounds__(GBUFFER_THREADS)
gbuffer_shade_kernel(const __grid_constant__ GBufferArgs a) {
  __shared__ PreparedLight tile[LIGHT_TILE];
  if constexpr (RESIDENT) stage_lights(a.lp, a.n_lights, tile);
  shade_gbuffer_pixels<RESIDENT>(a, tile);
}

template <bool RESIDENT>
cudaError_t launch_gbuffer(const GBufferArgs& a, cudaStream_t stream) {
  static int wave[MAX_DEVICES];
  auto kernel = gbuffer_shade_kernel<RESIDENT>;
  const int blocks = resident_grid(kernel, GBUFFER_THREADS, a.n, wave);
  kernel<<<blocks, GBUFFER_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
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
  using namespace bb;
  if (n <= 0) return (int)cudaGetLastError();
  const GBufferArgs a{wx, wy, wz, nx, ny, nz, ar, ag, ab, metallic,
                      roughness, ao, valid, vis_plane, amb_r, amb_g, amb_b,
                      lparams, n_lights, view_pos, exposure, tm_enable,
                      quantize, tonemap, n, out_r, out_g, out_b};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_lights <= LIGHT_TILE) return (int)launch_gbuffer<true>(a, s);
  return (int)launch_gbuffer<false>(a, s);
}
