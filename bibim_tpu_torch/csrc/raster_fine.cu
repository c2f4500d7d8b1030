// K11 — fine-subtile raster + resolve: pass 0 binned per 16x8-px subtile.
//
// Replaces bibim_tpu/ops/fused.py:_fused_kernel_fine (pass 0 of
// fine_bins frames; passes >= 1 stay on K1). One block per coarse 8x128
// tile, one warp per subtile g of tile_w / nsub x tile_h pixels (128 px,
// 4 per lane at 8x128). Subtile g's candidate sequence is the overflow
// list, then its own fine window pair_tri[start + lb_al[g] ...][:cntk[g]]
// of the tile's coarse window; per pixel the winner is the lexicographic
// maximum of (masked depth key, position) over the initial key (position
// -1) and the candidates — the sequential >= scan's result. Bases align
// down to 8 rows: the up to 7 prefix rows retested belong to the previous
// subtile, and a triangle covering this subtile also has its own pair here,
// at a later position, so it wins the duplicate tie and the result is
// exact. Pixels are written in screen order (the TPU kernel's fine-ordered
// (k, 8, 8, 16) layout and the transposes around it are not ported).
//
// What bounds it on an H100: the scan's arithmetic, about 1/nsub of K1's
// per candidate (each candidate is tested against 128 pixels, not 1024).
// One warp scanning its subtile's window alone left the block waiting on
// its deepest subtile, and every warp staged the overflow list for itself.
// So:
//   - The overflow list is staged once per block (cp.async); warp g scans
//     it for subtile g.
//   - The fine windows are cut into rounds of WSTAGE candidates; round j
//     of subtile g goes to warp (g + j mod parts) mod nsub, so a deep
//     window is spread over `parts` warps. Each warp keeps its subtile's
//     running (key, position) in registers between rounds of one subtile
//     and merges it into the block's per-pixel maximum in shared memory
//     (64-bit atomicMax of common.cuh pack_best) when it moves on. A round
//     starts from the merged value, so the merge order does not matter.
//   - A candidate whose edge function is negative at the four corner pixel
//     centres of the subtile is skipped for it: under -fmad=false the
//     rounded a*px + b*py + c is monotone in px and in py, so its maximum
//     over the subtile lies at a corner and the candidate covers none of
//     its pixels. Skipping a candidate drops only miss keys, exact once
//     every pixel's running key is above the miss key (checked per warp
//     and round; otherwise every candidate is tested). Lane i tests
//     candidate i of a round and a ballot leaves the survivors.
//   - The three edge functions come first; when no lane passes them, the
//     depth planes and the reciprocal are skipped (a miss's key does not
//     depend on them).
//   - Each warp stages its rounds with 16-byte cp.async copies,
//     double-buffered: round r+1's copies and round r+2's triangle ids are
//     in flight while round r is tested.
#include "common.cuh"

namespace bb {

constexpr int MAX_NSUB = 8;

struct FineArgs {
  const float* rec;
  int rec_stride;
  const int* big_ids;
  const int* n_big;
  int big_len;
  const int* pair_tri;
  int pair_len;
  const int* ids;
  const int* starts;
  const int* lb_al;
  const int* cntk;
  const int* init_zkey;
  int n_slots, nsub, tiles_x, tile_h, tile_w;
  unsigned mask;
  int* zkey;
  float* fields;
};

// One subtile's pixels as a warp holds them: lane l owns subtile pixels
// l, l + 32, ... (row-major in the sub_w-wide subtile).
template <int PPL>
struct SubtileScan {
  float px[PPL], py[PPL];
  int bkey[PPL], bidx[PPL];
  bool moved[PPL];
  float cx0, cx1, cy0, cy1;  // corner pixel centres
  int npl;
  bool cull;

  __device__ void init(const FineArgs& a, int s, int g, int npl_,
                       const unsigned long long* best) {
    const int lane = threadIdx.x & 31;
    const int tid = a.ids[s];
    const int row = tid / a.tiles_x, col = tid - row * a.tiles_x;
    const int sub_w = a.tile_w / a.nsub;
    npl = npl_;
    bool above = true;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int l = lane + 32 * k;
      px[k] = (float)(col * a.tile_w + g * sub_w + l % sub_w) + 0.5f;
      py[k] = (float)(row * a.tile_h + l / sub_w) + 0.5f;
      moved[k] = false;
      bkey[k] = 0;
      bidx[k] = -1;
      if (k < npl) {
        const unsigned long long v = best[l];
        bkey[k] = best_key(v);
        bidx[k] = best_idx(v);
        above &= bkey[k] > MISS_KEY;
      }
    }
    cx0 = (float)(col * a.tile_w + g * sub_w) + 0.5f;
    cx1 = (float)(col * a.tile_w + g * sub_w + sub_w - 1) + 0.5f;
    cy0 = (float)(row * a.tile_h) + 0.5f;
    cy1 = (float)(row * a.tile_h + a.tile_h - 1) + 0.5f;
    cull = __all_sync(0xffffffffu, above);
  }

  // Whether the staged candidate may cover a pixel of the subtile: each
  // edge function is >= 0 at one of the four corner pixel centres.
  __device__ bool may_cover(const float* co) const {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float a = co[e], b = co[3 + e], c = co[6 + e];
      if (!(plane_eval(a, b, c, cx0, cy0) >= 0.f ||
            plane_eval(a, b, c, cx1, cy0) >= 0.f ||
            plane_eval(a, b, c, cx0, cy1) >= 0.f ||
            plane_eval(a, b, c, cx1, cy1) >= 0.f))
        return false;
    }
    return true;
  }

  // Tests the n staged candidates at rows (STAGE_CH floats each; positions
  // pos0 + i): lane i culls candidate i, then the survivors are scanned in
  // order.
  __device__ void scan(const float* rows, int n, int pos0) {
    const int lane = threadIdx.x & 31;
    unsigned live = __ballot_sync(0xffffffffu, lane < n);
    if (cull) {
      const bool keep = lane < n && may_cover(rows + lane * STAGE_CH);
      live = __ballot_sync(0xffffffffu, keep);
    }
    while (live) {
      const int i = __ffs(live) - 1;
      live &= live - 1;
      const Staged st = load_staged(rows + i * STAGE_CH);
      const float* co = st.co;
      bool in[PPL];
      bool any_in = false;
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        in[k] = k < npl && edges_in(co, px[k], py[k]);
        any_in |= in[k];
      }
      const int c = pos0 + i;
      if (__any_sync(0xffffffffu, any_in)) {
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          if (k < npl) {
            int key = MISS_KEY;
            if (in[k]) {
              bool ok;
              key = depth_key(co, px[k], py[k], &ok);
            }
            if (key >= bkey[k]) {
              bkey[k] = key;
              bidx[k] = c;
              moved[k] = true;
            }
          }
        }
      } else if (!cull) {
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          if (k < npl && MISS_KEY >= bkey[k]) {
            bkey[k] = MISS_KEY;
            bidx[k] = c;
            moved[k] = true;
          }
        }
      }
    }
  }

  // Merges the running values that moved into the block's maximum.
  __device__ void flush(unsigned long long* best) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < PPL; ++k)
      if (k < npl && moved[k])
        atomicMax(&best[lane + 32 * k], pack_best(bkey[k], bidx[k]));
  }
};

// Moves (g, j) to the first round at or after it that warp w scans:
// rounds j = d, d + parts, ... of subtile g, d = (w - g) mod nsub < parts.
__device__ __forceinline__ void seek_round(int w, int nsub, int parts,
                                           const int* nrounds, int* g,
                                           int* j) {
  while (*g < nsub && *j >= nrounds[*g]) {
    if (++*g < nsub) {
      const int d = (w - *g + nsub) % nsub;
      *j = d < parts ? d : INT_MAX;
    }
  }
}

template <int PPL>
__global__ void __launch_bounds__(MAX_NSUB * 32)
raster_fine_kernel(const FineArgs a, int parts) {
  // WSTAGE candidates a warp round: 32, or 16 with 8 pixels a lane, so the
  // staging (32 / 16 KB) and the per-pixel maxima (8 / 16 KB) fit.
  constexpr int WSTAGE = PPL <= 4 ? 32 : 16;
  constexpr int OV = MAX_NSUB * 2 * WSTAGE;  // overflow candidates a round
  __shared__ __align__(16) float sco[MAX_NSUB][2][WSTAGE][STAGE_CH];
  __shared__ unsigned long long sbest[MAX_NSUB][32 * PPL];
  __shared__ int snr[MAX_NSUB];  // rounds of each subtile's window
  float (*sov)[STAGE_CH] = &sco[0][0][0];

  const int s = blockIdx.x;
  const int nsub = a.nsub;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int npx = a.tile_h * a.tile_w;
  const int sub_w = a.tile_w / nsub;
  const int npl = a.tile_h * sub_w / 32;
  const int nb = min(*a.n_big, a.big_len);
  const int start = a.starts[s];
  parts = min(parts, nsub);
  if (threadIdx.x < nsub)
    snr[threadIdx.x] =
        (a.cntk[s * nsub + threadIdx.x] + WSTAGE - 1) / WSTAGE;

  // The initial keys (position -1) of warp w's subtile.
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int l = lane + 32 * k;
    if (k < npl) {
      const int p = (l / sub_w) * a.tile_w + w * sub_w + l % sub_w;
      sbest[w][l] = pack_best(a.init_zkey[(size_t)s * npx + p] & LOW3, -1);
    }
  }
  __syncwarp();

  // The overflow list, staged once per block, OV candidates a round.
  SubtileScan<PPL> sc;
  sc.init(a, s, w, npl, sbest[w]);
  for (int base = 0; base < nb; base += OV) {
    const int n = min(OV, nb - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      stage_row(sov[i], a.rec, a.rec_stride, a.big_ids[base + i], 0, 4);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = 0; i < n; i += 32)
      sc.scan(sov[i], min(32, n - i), base + i);
    __syncthreads();
  }
  sc.flush(sbest[w]);
  __syncthreads();

  // The fine windows, round by round: (g, j) is scanned, (g1, j1) staged,
  // (g2, j2)'s triangle ids loaded.
  float (*buf)[WSTAGE][STAGE_CH] = sco[w];
  auto tri_of = [&](int g, int j) {
    const int r = j * WSTAGE + lane;
    if (g >= nsub || lane >= WSTAGE || r >= a.cntk[s * nsub + g]) return -1;
    const int pi = start + a.lb_al[s * nsub + g] + r;
    return (pi >= 0 && pi < a.pair_len) ? a.pair_tri[pi] : -1;
  };
  auto stage = [&](int b, int tri) {
    if (lane < WSTAGE) stage_row(buf[b][lane], a.rec, a.rec_stride, tri, 0, 4);
    cp_async_commit();
  };
  auto next = [&](int* gg, int* jj) {
    if (*gg < nsub) *jj += parts;
    seek_round(w, nsub, parts, snr, gg, jj);
  };
  int g = 0, j = w < parts ? w : INT_MAX;
  seek_round(w, nsub, parts, snr, &g, &j);
  int g1 = g, j1 = j;
  next(&g1, &j1);
  int g2 = g1, j2 = j1;
  next(&g2, &j2);
  if (g < nsub) stage(0, tri_of(g, j));
  int tri_next = tri_of(g1, j1);
  int held = -1;  // the subtile whose running values sc holds
  for (int b = 0; g < nsub; b ^= 1) {
    if (g1 < nsub) {
      stage(b ^ 1, tri_next);
      tri_next = tri_of(g2, j2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (g != held) {
      if (held >= 0) sc.flush(sbest[held]);
      sc.init(a, s, g, npl, sbest[g]);
      held = g;
    }
    sc.scan(buf[b][0], min(WSTAGE, a.cntk[s * nsub + g] - j * WSTAGE),
            nb + j * WSTAGE);
    __syncwarp();
    g = g1;
    j = j1;
    g1 = g2;
    j1 = j2;
    next(&g2, &j2);
  }
  if (held >= 0) sc.flush(sbest[held]);
  __syncthreads();

  // Resolve and write in screen order, consecutive threads on consecutive
  // pixels.
  const int tid = a.ids[s];
  const int row = tid / a.tiles_x, col = tid - row * a.tiles_x;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const int y = p / a.tile_w, x = p - y * a.tile_w;
    const int gp = x / sub_w;
    const unsigned long long v = sbest[gp][y * sub_w + x - gp * sub_w];
    const int idx = best_idx(v);
    const int tri =
        idx < 0 ? -1
                : candidate_tri(a.big_ids, nb, a.pair_tri, a.pair_len,
                                start + a.lb_al[s * nsub + gp], idx);
    write_pixel(a.rec, a.rec_stride, tri, best_key(v),
                (float)(col * a.tile_w + x) + 0.5f,
                (float)(row * a.tile_h + y) + 0.5f, a.mask, s, a.n_slots,
                npx, p, a.zkey, a.fields);
  }
}

}  // namespace bb

extern "C" int bb_raster_fine(const float* rec, const int* big_ids,
                              const int* n_big, int big_len,
                              const int* pair_tri, int pair_len,
                              const int* ids, const int* starts,
                              const int* lb_al, const int* cntk,
                              const int* init_zkey, int n_slots, int nsub,
                              int tiles_x, int tile_h, int tile_w,
                              int rec_stride, unsigned mask, int parts,
                              int* zkey, float* fields, void* stream) {
  const int sub_px = nsub > 0 ? tile_h * (tile_w / nsub) : 0;
  if (nsub < 1 || nsub > bb::MAX_NSUB || tile_w % nsub != 0 ||
      sub_px % 32 != 0 || sub_px < 32 || sub_px > 32 * bb::MAX_PPT ||
      rec_stride % 4 != 0 || rec_stride < bb::STAGE_CH || parts < 1)
    return (int)cudaErrorInvalidValue;
  if (n_slots <= 0) return (int)cudaGetLastError();
  const bb::FineArgs a{rec,     rec_stride, big_ids, n_big,    big_len,
                       pair_tri, pair_len,  ids,     starts,   lb_al,
                       cntk,    init_zkey,  n_slots, nsub,     tiles_x,
                       tile_h,  tile_w,     mask,    zkey,     fields};
  const cudaStream_t st = (cudaStream_t)stream;
  const int npl = sub_px / 32;
  auto go = [&](auto kernel) {
    kernel<<<n_slots, nsub * 32, 0, st>>>(a, parts);
    return (int)cudaGetLastError();
  };
  if (npl <= 1) return go(bb::raster_fine_kernel<1>);
  if (npl <= 2) return go(bb::raster_fine_kernel<2>);
  if (npl <= 4) return go(bb::raster_fine_kernel<4>);
  return go(bb::raster_fine_kernel<8>);
}
