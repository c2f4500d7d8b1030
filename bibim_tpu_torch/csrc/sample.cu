// K6 — block-table bilinear sample; K7 — small quad-table sample. One
// thread per pixel; each writes one float plane per present slot.
//
// K6 replaces bibim_tpu/ops/texture_quad.py:_block_blend_kernel (launched
// by sample_table_block_pallas), with the block_prep that feeds it. The
// TPU path gathers every pixel's 128-byte block row and transposes the
// rows to (NT, 128, NPX) through device memory (taps on sublanes, pixels
// on lanes) before a 25-tap blend; here each thread computes its
// footprint, reads its block row by index (y0/4)*nbx + x0/4 and blends
// only the 4 live taps in the reference's (j, i) order, which is
// bit-equal because the 21 dead taps add exact zeros. At pair rate
// (pair_rows 1 / 2: 2x1 / 2x2 pixel groups) the TPU kernel expands a
// group-rate row gather by lane-segment concatenation in a member-major
// pixel order (member_perm), because Mosaic cannot shuffle lanes; here
// each thread reads its group's members' coverage and uv, computes the
// same integer anchor (shading.cuh pair_block_footprint) and reads the
// anchor's row, which the group's threads share through L1: the pixel
// order of the planes does not change.
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

// Pair level 1 (RX = 1) or 2 (RX = 2); valid may be NULL (all covered).
template <int RX>
__global__ void __launch_bounds__(256)
sample_block_pair_kernel(const uint8_t* __restrict__ blocks, int row_bytes,
                         int h, int w, int cpad, int n_out,
                         const float* __restrict__ u,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ valid, int npx,
                         int tile_w, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int lx, ly;
  float tx, ty;
  const int r = pair_block_footprint<RX>(u, v, valid, i, npx, tile_w, h, w,
                                         u[i], v[i], &lx, &ly, &tx, &ty);
  float acc[N_SLOTS];
  blend_block(blocks + (size_t)r * row_bytes, lx, ly, tx, ty, cpad, n_out,
              acc);
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

// pair: 0 per pixel, 1 / 2 the pair level (npx pixels a tile row-major,
// tile_w a row; valid NULL: all covered).
extern "C" int bb_sample_block(const uint8_t* blocks, int row_bytes, int h,
                               int w, int cpad, int n_out, const float* u,
                               const float* v, const uint8_t* valid,
                               int pair, int npx, int tile_w, int n,
                               float* out, void* stream) {
  if (n > 0) {
    const int threads = 256, grid = (n + threads - 1) / threads;
    const cudaStream_t s = (cudaStream_t)stream;
    if (pair == 0)
      bb::sample_block_kernel<<<grid, threads, 0, s>>>(
          blocks, row_bytes, h, w, cpad, n_out, u, v, n, out);
    else if (pair == 1)
      bb::sample_block_pair_kernel<1><<<grid, threads, 0, s>>>(
          blocks, row_bytes, h, w, cpad, n_out, u, v, valid, npx, tile_w, n,
          out);
    else
      bb::sample_block_pair_kernel<2><<<grid, threads, 0, s>>>(
          blocks, row_bytes, h, w, cpad, n_out, u, v, valid, npx, tile_w, n,
          out);
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
