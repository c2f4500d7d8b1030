// K8 — trilinear mip-block sample: one thread per pixel; each writes one
// float plane per present slot.
//
// Replaces bibim_tpu/ops/texture_quad.py:_mip_block_kernel (launched by
// sample_mip_block_pallas). The TPU path gathers every pixel's block row
// and transposes the rows to (NT, row_bytes, NPX) through device memory so
// that the 41-tap blend runs with taps on sublanes; XLA computes the nine
// geometry planes beforehand. Here the geometry planes come from the same
// torch ops (texture_quad._mip_block_geometry, shared with K2's mip-block
// group and both plain versions, so the floor(log2 rho) level choice is
// identical on both sides), and each thread copies its own row by index with
// 16-byte loads into a private slot of shared memory, then blends the 4 live
// child and 4 live parent taps in the reference's order (shading.cuh
// mip_block_blend) — bit-equal, since the dead taps add exact zeros.
//
// What bounds it on an H100: memory — per pixel 40 bytes of geometry in,
// one 128-byte row (config 2: 3 albedo channels x 41 taps) out of a
// 56 MB two-material table, scattered by the LOD, and 4 bytes out per slot;
// about 40 flops per channel.
#include "shading.cuh"

namespace bb {

constexpr int MIP_THREADS = 64;

__global__ void __launch_bounds__(MIP_THREADS)
mip_block_kernel(const uint8_t* __restrict__ blocks, int row_bytes, int cs,
                 const int* __restrict__ gi, const float* __restrict__ gf,
                 int n, float* __restrict__ out) {
  // One row per thread, padded by 16 bytes so that the 16-byte stores of
  // neighbouring threads fall on different banks.
  extern __shared__ uint4 rows[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  MipGeom g;
  const int r = load_mip_geom(gi, gf, i, n, &g);
  const int words = row_bytes / 16;
  uint4* mine = rows + threadIdx.x * (words + 1);
  const uint4* src =
      reinterpret_cast<const uint4*>(blocks + (size_t)r * row_bytes);
  for (int k = 0; k < words; ++k) mine[k] = __ldg(src + k);
  float acc[N_SLOTS];
  mip_block_blend(reinterpret_cast<const uint8_t*>(mine), cs, g, cs, acc);
  for (int k = 0; k < cs; ++k) out[(size_t)k * n + i] = acc[k];
}

}  // namespace bb

extern "C" int bb_sample_mip_block(const uint8_t* blocks, int row_bytes,
                                   int cs, const int* gi, const float* gf,
                                   int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = bb::MIP_THREADS;
    const size_t smem = (size_t)threads * (row_bytes + 16);
    bb::mip_block_kernel<<<(n + threads - 1) / threads, threads, smem,
                           (cudaStream_t)stream>>>(blocks, row_bytes, cs, gi,
                                                   gf, n, out);
  }
  return (int)cudaGetLastError();
}
