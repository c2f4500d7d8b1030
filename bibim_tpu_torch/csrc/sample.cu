// K6 — block-table bilinear sample; K7 — small quad-table sample. Each
// writes one float plane per present slot.
//
// K6 replaces bibim_tpu/ops/texture_quad.py:_block_blend_kernel (launched
// by sample_table_block_pallas), with the block_prep that feeds it. The
// TPU path gathers every pixel's 128-byte block row and transposes the
// rows to (NT, 128, NPX) through device memory (taps on sublanes, pixels
// on lanes) before a 25-tap blend; here a thread computes a pixel's
// footprint, reads its block row by index (y0/4)*nbx + x0/4 and blends
// only the 4 live taps in the reference's (j, i) order, which is
// bit-equal because the 21 dead taps add exact zeros. It samples every
// pixel, misses included, as the plain version does.
//
// What bounds K6 on an H100: bytes — per pixel 8 bytes of uv in, one
// block row (the 2048^2 table is 33.5 MB, two thirds of L2, so the row
// reads are scattered 32-byte sectors) and 4 bytes out per slot, against
// 8 flops a tap and channel. So the design spends few instructions a byte:
// - the channel stride CPAD (4, 8 or 12) is a template argument, and a
//   tap's CPAD channels are CPAD/4 aligned 32-bit words through the
//   read-only path (blend_block_words; shading.cuh load_words, shared
//   with K2), not one byte load a channel;
// - at pair level 0 a thread takes SAMPLE_VEC pixels: 16-byte loads of u
//   and v, 16-byte stores to each slot plane (planes padded to a multiple
//   of SAMPLE_VEC floats by the wrapper, the last n % SAMPLE_VEC pixels one
//   a thread), the footprint's wrap without a division where uv lies in
//   [-1, 2) (footprint<true>);
// - one resident wave of blocks walks the pixels (grid-stride).
// At pair rate (pair_rows 1 / 2: 2x1 / 2x2 pixel groups read one block row)
// the TPU kernel expands a group-rate row gather by lane-segment
// concatenation in a member-major pixel order (member_perm), because
// Mosaic cannot shuffle lanes. Here a group sits in one warp (shading.cuh
// pair_pixel): each lane computes its own footprint once, and the group's
// integer anchor is a min over its lanes by shuffles (group_anchor), so
// the group's lanes read the anchor's row in one request; the planes'
// pixel order does not change.
//
// K7 replaces bibim_tpu/ops/texture_quad.py:_small_kernel (launched by
// sample_rows_small_pallas): a one-hot select of the texel row on the MXU
// followed by the _blend bilinear mix. Here each thread reads its quad row
// by index (16 or 32 bytes; an index outside the table selects nothing and
// samples 0, as the one-hot does) and mixes it in the _blend order. What
// bounds it: bytes, 12 in per pixel (idx, tx, ty), an L2-resident row and
// 4 out per slot.
#include "shading.cuh"

namespace bb {

constexpr int SAMPLE_THREADS = 256;
constexpr int SAMPLE_VEC = 4;  // K6 pixels a thread at pair level 0

// Channels J < np of a block-table row (channel stride CPAD: 4, 8 or 12)
// at block-local tap (lx, ly): the 4 live taps of the 5x5 neighbourhood
// (the reference's 21 dead taps add exact zeros), each read as CPAD/4
// aligned words (a tap starts 4-byte aligned for every CPAD and 8-byte
// aligned for CPAD 8, in rows that start 16-byte aligned), summed in the
// (j, i) row-major order, each weighted wx * wy. K2 (shade.cu
// sample_block) spells the same blend inline: called through a function
// its level-0 instantiations compiled to 16 more SASS instructions.
template <int CPAD>
__device__ __forceinline__ void blend_block_words(const uint8_t* row, int lx,
                                                  int ly, float tx, float ty,
                                                  int np,
                                                  float (&acc)[N_SLOTS]) {
  constexpr int NW = CPAD / 4;
  const int t00 = (ly * 5 + lx) * CPAD;
  uint32_t q00[NW], q01[NW], q10[NW], q11[NW];
  load_words<NW>(row + t00, q00);
  load_words<NW>(row + t00 + CPAD, q01);
  load_words<NW>(row + t00 + 5 * CPAD, q10);
  load_words<NW>(row + t00 + 6 * CPAD, q11);
  const float omtx = 1.f - tx, omty = 1.f - ty;
  const float w00 = omtx * omty, w01 = tx * omty;
  const float w10 = omtx * ty, w11 = tx * ty;
  static_for<0, (CPAD < N_SLOTS ? CPAD : N_SLOTS)>([&](auto j) {
    constexpr int J = decltype(j)::value;
    if (J < np) {
      float x = word_tap<J>(q00) * w00;
      x = x + word_tap<J>(q01) * w01;
      x = x + word_tap<J>(q10) * w10;
      x = x + word_tap<J>(q11) * w11;
      acc[J] = x;
    }
  });
}

// One pixel of K6 at pair level 0: channels J < n_out into acc.
template <int CPAD>
__device__ __forceinline__ void sample_pixel(const uint8_t* blocks,
                                             int row_bytes, int h, int w,
                                             int n_out, float u, float v,
                                             float (&acc)[N_SLOTS]) {
  int x0i, y0i;
  float tx, ty;
  footprint<true>(u, v, h, w, &x0i, &y0i, &tx, &ty);
  const unsigned bx = (unsigned)x0i / 4, by = (unsigned)y0i / 4;
  const uint8_t* row =
      blocks + (size_t)(by * ((unsigned)w / 4) + bx) * row_bytes;
  blend_block_words<CPAD>(row, x0i & 3, y0i & 3, tx, ty, n_out, acc);
}

// Slot planes start ``ns`` floats apart (ns: n rounded up to SAMPLE_VEC).
template <int CPAD>
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_block_kernel(const uint8_t* __restrict__ blocks, int row_bytes, int h,
                    int w, int n_out, const float* __restrict__ u,
                    const float* __restrict__ v, int n, int ns,
                    float* __restrict__ out) {
  constexpr int NC = CPAD < N_SLOTS ? CPAD : N_SLOTS;
  const int nq = n / SAMPLE_VEC;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int q = t0; q < nq; q += gridDim.x * blockDim.x) {
    const float4 uq = __ldg(reinterpret_cast<const float4*>(u) + q);
    const float4 vq = __ldg(reinterpret_cast<const float4*>(v) + q);
    const float us[SAMPLE_VEC] = {uq.x, uq.y, uq.z, uq.w};
    const float vs[SAMPLE_VEC] = {vq.x, vq.y, vq.z, vq.w};
    float acc[SAMPLE_VEC][N_SLOTS];
#pragma unroll
    for (int p = 0; p < SAMPLE_VEC; ++p)
      sample_pixel<CPAD>(blocks, row_bytes, h, w, n_out, us[p], vs[p],
                         acc[p]);
    static_for<0, NC>([&](auto j) {
      constexpr int J = decltype(j)::value;
      if (J < n_out)
        reinterpret_cast<float4*>(out + (size_t)J * ns)[q] =
            make_float4(acc[0][J], acc[1][J], acc[2][J], acc[3][J]);
    });
  }
  const int i = nq * SAMPLE_VEC + t0;  // the last n % SAMPLE_VEC pixels
  if (i < n) {
    float acc[N_SLOTS];
    sample_pixel<CPAD>(blocks, row_bytes, h, w, n_out, u[i], v[i], acc);
    static_for<0, NC>([&](auto j) {
      constexpr int J = decltype(j)::value;
      if (J < n_out) out[(size_t)J * ns + i] = acc[J];
    });
  }
}

// Pair level 1 (RX = 1) or 2 (RX = 2) in pair_pixel's warp mapping; valid
// may be NULL (all covered). n is a multiple of 2 * tile_w, itself of 32,
// so a warp's indices are all below n or none is, and its lanes reach the
// shuffles together.
template <int RX, int CPAD>
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_block_pair_kernel(const uint8_t* __restrict__ blocks, int row_bytes,
                         int h, int w, int n_out, const float* __restrict__ u,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ valid, int tile_w,
                         int n, float* __restrict__ out) {
  constexpr int NC = CPAD < N_SLOTS ? CPAD : N_SLOTS;
  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < n;
       f += gridDim.x * blockDim.x) {
    const int i = pair_pixel<RX>(f, tile_w);
    int x0i, y0i, xr, yr;
    float tx, ty;
    footprint<true>(__ldg(u + i), __ldg(v + i), h, w, &x0i, &y0i, &tx, &ty);
    group_anchor<RX>(x0i, y0i, valid == nullptr || valid[i] != 0, &xr,
                     &yr);
    const BlockTap t = window_tap(x0i, y0i, tx, ty, xr, yr, h, w);
    float acc[N_SLOTS];
    blend_block_words<CPAD>(blocks + (size_t)t.r * row_bytes, t.lx, t.ly,
                            t.tx, t.ty, n_out, acc);
    static_for<0, NC>([&](auto j) {
      constexpr int J = decltype(j)::value;
      if (J < n_out) out[(size_t)J * n + i] = acc[J];
    });
  }
}

template <int CPAD>
cudaError_t launch_sample_block(const uint8_t* blocks, int row_bytes, int h,
                                int w, int n_out, const float* u,
                                const float* v, const uint8_t* valid,
                                int pair, int tile_w, int n, int ns,
                                float* out, cudaStream_t s) {
  constexpr int T = SAMPLE_THREADS;
  if (pair == 0) {
    static int wave[MAX_DEVICES];
    auto k = sample_block_kernel<CPAD>;
    k<<<resident_grid(k, T, (n + SAMPLE_VEC - 1) / SAMPLE_VEC, wave), T, 0,
        s>>>(blocks, row_bytes, h, w, n_out, u, v, n, ns, out);
  } else if (pair == 1) {
    static int wave[MAX_DEVICES];
    auto k = sample_block_pair_kernel<1, CPAD>;
    k<<<resident_grid(k, T, n, wave), T, 0, s>>>(
        blocks, row_bytes, h, w, n_out, u, v, valid, tile_w, n, out);
  } else {
    static int wave[MAX_DEVICES];
    auto k = sample_block_pair_kernel<2, CPAD>;
    k<<<resident_grid(k, T, n, wave), T, 0, s>>>(
        blocks, row_bytes, h, w, n_out, u, v, valid, tile_w, n, out);
  }
  return cudaGetLastError();
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

// pair: 0 per pixel, 1 / 2 the pair level (planes of tile_w-wide tile rows,
// tile_w % 16 == 0, n a multiple of 2 * tile_w; valid NULL: all covered).
// Slot plane k of out starts at k * ns (ns = n at the pair levels).
// cpad: 4, 8 or 12; blocks and its rows 16-byte aligned, u and v too at
// pair level 0.
extern "C" int bb_sample_block(const uint8_t* blocks, int row_bytes, int h,
                               int w, int cpad, int n_out, const float* u,
                               const float* v, const uint8_t* valid,
                               int pair, int tile_w, int n, int ns,
                               float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cpad) {
    case 4:
      return (int)bb::launch_sample_block<4>(blocks, row_bytes, h, w, n_out,
                                             u, v, valid, pair, tile_w, n, ns,
                                             out, s);
    case 8:
      return (int)bb::launch_sample_block<8>(blocks, row_bytes, h, w, n_out,
                                             u, v, valid, pair, tile_w, n, ns,
                                             out, s);
    case 12:
      return (int)bb::launch_sample_block<12>(blocks, row_bytes, h, w,
                                              n_out, u, v, valid, pair,
                                              tile_w, n, ns, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
