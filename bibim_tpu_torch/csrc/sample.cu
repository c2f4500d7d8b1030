// K6 — block-table bilinear sample; K7 — small quad-table sample. One
// thread per pixel; each writes one float plane per present slot.
//
// K6 replaces bibim_tpu/ops/texture_quad.py:_block_blend_kernel (launched
// by sample_table_block_pallas) at pair_rows=0, with the block_prep that
// feeds it. The TPU path gathers every pixel's 128-byte block row and
// transposes the rows to (NT, 128, NPX) through device memory (taps on
// sublanes, pixels on lanes) before a 25-tap blend; here each thread
// computes its footprint, reads its block row by index (y0/4)*nbx + x0/4
// and blends only the 4 live taps in the reference's (j, i) order, which
// is bit-equal because the 21 dead taps add exact zeros.
//
// K7 replaces bibim_tpu/ops/texture_quad.py:_small_kernel (launched by
// sample_rows_small_pallas): a one-hot select of the texel row on the MXU
// followed by the _blend bilinear mix. Here each thread reads its quad row
// by index (16 or 32 bytes; an index outside the table selects nothing and
// samples 0, as the one-hot does) and mixes it in the _blend order.
//
// What bounds both on an H100: memory — per pixel 8 (K6: u, v) or 12
// (K7: idx, tx, ty) bytes in, one table row (L2-resident for the 16^2 and
// IBL tables; the 2048^2 block table is 33.5 MB, two thirds of L2, so K6's
// row reads are scattered sectors), and 4 bytes out per slot; a few flops
// each.
#include "shading.cuh"

namespace bb {

__global__ void __launch_bounds__(256)
sample_block_kernel(const uint8_t* __restrict__ blocks, int row_bytes, int h,
                    int w, int cpad, int n_out, const float* __restrict__ u,
                    const float* __restrict__ v, int n,
                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x0i, y0i;
  float tx, ty;
  footprint(u[i], v[i], h, w, &x0i, &y0i, &tx, &ty);
  const uint8_t* row =
      blocks + (size_t)((y0i / 4) * (w / 4) + (x0i / 4)) * row_bytes;
  float acc[N_SLOTS];
  blend_block(row, x0i % 4, y0i % 4, tx, ty, cpad, n_out, acc);
  for (int k = 0; k < n_out; ++k) out[(size_t)k * n + i] = acc[k];
}

__global__ void __launch_bounds__(256)
sample_small_kernel(const uint8_t* __restrict__ quads, int rows, int cpad,
                    int n_out, const int* __restrict__ idx,
                    const float* __restrict__ tx, const float* __restrict__ ty,
                    int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = idx[i];
  if (r < 0 || r >= rows) {
    for (int k = 0; k < n_out; ++k) out[(size_t)k * n + i] = 0.f;
    return;
  }
  const uint8_t* row = quads + (size_t)r * 4 * cpad;
  const float fx = tx[i], fy = ty[i];
  for (int k = 0; k < n_out; ++k)
    out[(size_t)k * n + i] = blend_quad(row, k, cpad, fx, fy);
}

}  // namespace bb

extern "C" int bb_sample_block(const uint8_t* blocks, int row_bytes, int h,
                               int w, int cpad, int n_out, const float* u,
                               const float* v, int n, float* out,
                               void* stream) {
  if (n > 0) {
    const int threads = 256;
    bb::sample_block_kernel<<<(n + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
        blocks, row_bytes, h, w, cpad, n_out, u, v, n, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int bb_sample_small(const uint8_t* quads, int rows, int cpad,
                               int n_out, const int* idx, const float* tx,
                               const float* ty, int n, float* out,
                               void* stream) {
  if (n > 0) {
    const int threads = 256;
    bb::sample_small_kernel<<<(n + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
        quads, rows, cpad, n_out, idx, tx, ty, n, out);
  }
  return (int)cudaGetLastError();
}
