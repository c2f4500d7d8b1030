// K8 — trilinear mip-block sample: the level choice, the footprint and
// the blend of one pixel a thread, writing one float plane per present
// slot.
//
// Replaces bibim_tpu/ops/texture_quad.py:_mip_block_kernel (launched by
// sample_mip_block_pallas). The TPU path has XLA compute nine geometry
// planes, gathers every pixel's block row and transposes the rows to
// (NT, row_bytes, NPX) through device memory so that the 41-tap blend runs
// with taps on sublanes. Here one kernel reads u, v and the material id
// and does it all in registers:
//   - A warp covers 2 rows x 16 columns of a tile, so a pixel's 2x2-quad
//     partners are lanes lane ^ 1 (x) and lane ^ 16 (y): the uv
//     differences (right - left, bottom - top, both pixels of a pair
//     alike: texture_quad._quad_diffs_planar) come by shuffle. A block
//     is a row pair of one tile (a 3-D grid: no index division).
//   - The LOD, level and footprint are shading.cuh mip_geometry, the torch
//     geometry's operations in its order, from a per-material table of a
//     few dozen ints (texture_quad.mip_level_table).
//   - Only the 8 live taps are read, byte by byte straight from the row
//     through the read-only path (no copy of the 128-byte row), from two
//     base addresses; neighbouring pixels share rows, so L1 catches the
//     reuse. The blend is shading.cuh mip_channel, K2's too, in the
//     reference's order — bit-equal, since the dead taps add exact zeros.
//   - Planes are written per slot, each warp two 64-byte runs.
//
// What bounds it on an H100: its least time is memory's — per pixel 8
// bytes of uv, 4 of material id and 4 out per slot (config 2: 24 bytes),
// plus the distinct 128-byte rows the LOD picks out of a 56 MB
// two-material table — but it runs at about twice that, held by
// instruction issue: about 600 instructions for 3 slots, the log2f
// polynomial and two IEEE square roots among them, and a byte load, a
// conversion and two multiplies a tap (PERF.md, the K8 variants).
#include "shading.cuh"

namespace bb {

constexpr int MIP_THREADS = 256;

struct MipArgs {
  const uint8_t* blocks;
  int row_bytes;
  const int* levels;  // texture_quad.mip_level_table
  int nmat, nlev;
  const float* u;
  const float* v;
  const int* mat;  // nullptr: material 0 everywhere
  int nt, tile_h, tile_w;
  float* out;  // (cs, nt, tile_h * tile_w)
};

template <int CS>
__global__ void __launch_bounds__(MIP_THREADS)
mip_block_kernel(const MipArgs a) {
  // Block (tile, row pair, 128-column run); warp w of it: 16 columns.
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int x = 16 * (blockIdx.z * (MIP_THREADS / 32) + (threadIdx.x >> 5)) +
                (lane & 15);
  if (x - (lane & 15) >= a.tile_w) return;  // whole warps: shuffles stay full
  const int y = 2 * blockIdx.y + (lane >> 4);
  const int npx = a.tile_h * a.tile_w;
  const size_t n = (size_t)a.nt * npx;
  const size_t i = (size_t)tile * npx + y * a.tile_w + x;
  const float u = __ldg(a.u + i), v = __ldg(a.v + i);
  const int mat = a.mat != nullptr ? __ldg(a.mat + i) : 0;
  const float ux = __shfl_xor_sync(0xffffffffu, u, 1);
  const float vx = __shfl_xor_sync(0xffffffffu, v, 1);
  const float uy = __shfl_xor_sync(0xffffffffu, u, 16);
  const float vy = __shfl_xor_sync(0xffffffffu, v, 16);
  const bool right = lane & 1, bottom = lane & 16;
  MipGeom g;
  const int idx = mip_geometry(
      a.levels, a.nmat, a.nlev, mat, u, v, right ? u - ux : ux - u,
      right ? v - vx : vx - v, bottom ? u - uy : uy - u,
      bottom ? v - vy : vy - v, &g);
  const MipTaps t = mip_taps(CS, g);
  const uint8_t* row = a.blocks + (size_t)idx * a.row_bytes;
  float* out = a.out + i;
#pragma unroll
  for (int k = 0; k < CS; ++k) out[k * n] = mip_channel(row, CS, t, k);
}

template <int CS>
int launch_mip(const MipArgs& a, cudaStream_t st) {
  const int runs = (a.tile_w + 16 * (MIP_THREADS / 32) - 1) /
                   (16 * (MIP_THREADS / 32));
  mip_block_kernel<CS>
      <<<dim3(a.nt, a.tile_h / 2, runs), MIP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bb

extern "C" int bb_sample_mip_block(const uint8_t* blocks, int row_bytes,
                                   int cs, const int* levels, int nmat,
                                   int nlev, const float* u, const float* v,
                                   const int* mat, int nt, int tile_h,
                                   int tile_w, float* out, void* stream) {
  if (tile_h <= 0 || tile_h % 2 || tile_w <= 0 || tile_w % 16 || nmat < 1 ||
      nlev < 1)
    return (int)cudaErrorInvalidValue;
  if (nt <= 0) return (int)cudaGetLastError();
  const bb::MipArgs a{blocks, row_bytes, levels, nmat, nlev,   u,
                      v,      mat,       nt,     tile_h, tile_w, out};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cs) {
    case 1: return bb::launch_mip<1>(a, st);
    case 2: return bb::launch_mip<2>(a, st);
    case 3: return bb::launch_mip<3>(a, st);
    case 4: return bb::launch_mip<4>(a, st);
    case 5: return bb::launch_mip<5>(a, st);
    case 6: return bb::launch_mip<6>(a, st);
    case 7: return bb::launch_mip<7>(a, st);
    case 8: return bb::launch_mip<8>(a, st);
    case 9: return bb::launch_mip<9>(a, st);
    case 10: return bb::launch_mip<10>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
