// Device code shared by the raster kernels (K1, K10 and the overlay
// composite K4 in raster.cu, K9 raster_earlyz.cu, K11 raster_fine.cu): the
// candidate coverage/depth test, the cp.async staging of candidate records,
// the packed (key, index) maximum and the cluster split of a slot's
// candidates (K1, K4, K9, K10; K11 packs too) and the winner's attribute
// resolve.
//
// Semantics (the reference kernel's, bibim_tpu/ops/fused.py _chunk_test):
// homogeneous edge functions E_e = A_e*px + B_e*py + C_e, coverage when all
// three are >= 0, inside the depth range 0 <= zn <= wn with wn > 0; the
// reversed-Z packed key is bits(z) & ~7 with z = zn * rcp(wn), and a
// candidate replaces the running winner when its key is >= the running key,
// so the later candidate wins a tie. The whole library is compiled with
// -fmad=false: every a*b+c below rounds the product and the sum separately,
// as the plain PyTorch versions do.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace bb {

// Record channel layout (bibim_tpu_torch/ops/fused.py).
constexpr int CH_A = 0, CH_B = 3, CH_C = 6, CH_ZC = 9, CH_WC = 12;
constexpr int CH_ID = 15, CH_U = 16, CH_V = 19, CH_N = 22, CH_T = 31;
constexpr int CH_W = 40, CH_COL = 49, CH_MAT = 58, CH_ZUB = 59;
constexpr int COV_CH = 15;    // coverage coefficients per candidate
constexpr int STAGE = 128;    // candidates staged per shared-memory round
constexpr int STAGE_CH = 16;  // floats cp.async stages per candidate
                              // (4 x 16 bytes: coverage and _ID)
constexpr int THREADS = 256;  // threads per tile block
constexpr int MAX_PPT = 8;    // pixels per thread: tiles up to 2048 px
constexpr int LOW3 = ~7;
// The fewest candidates a cluster block of K1 / K9 scans (the last part
// may hold fewer): a slot with at most MIN_PART is scanned by rank 0 alone.
constexpr int MIN_PART = 64;
// K4's: an overlay call scans a few dozen short windows, so a slot's scan
// on one SM is its time (parts of 8 took 0.017-0.021 ms on an H100 where
// parts of 64 took 0.033-0.040; PERF.md).
constexpr int OVERLAY_MIN_PART = 8;

__device__ __forceinline__ float plane_eval(float a, float b, float c,
                                            float px, float py) {
  return a * px + b * py + c;
}

// The same test in two steps, for K9 and K11, which skip the depth planes
// when no lane of a warp passes a candidate's edges (K1 keeps its own
// copy, which K4 and K10 share: through these two it ran 4-6 % slower on
// an H100, PERF.md).
// edges_in: whether a candidate passes its three edge functions at a
// pixel.
__device__ __forceinline__ bool edges_in(const float* co, float px,
                                         float py) {
  return plane_eval(co[0], co[3], co[6], px, py) >= 0.f &&
         plane_eval(co[1], co[4], co[7], px, py) >= 0.f &&
         plane_eval(co[2], co[5], co[8], px, py) >= 0.f;
}

// Masked depth key at a pixel whose edge functions passed (edges_in): the
// depth range test, z = zn * rcp(wn) and the key (negative for a miss).
__device__ __forceinline__ int depth_key(const float* co, float px, float py,
                                         bool* covers) {
  const float zn = plane_eval(co[9], co[10], co[11], px, py);
  const float wn = plane_eval(co[12], co[13], co[14], px, py);
  const bool ok = wn > 0.f && zn >= 0.f && zn <= wn;
  const float z = zn * __frcp_rn(wn == 0.f ? 1.f : wn);
  *covers = ok;
  return __float_as_int(ok ? z : -1.f) & LOW3;
}

// The key of a candidate that misses a pixel.
constexpr int MISS_KEY = (int)0xBF800000u & LOW3;  // bits(-1.0f) & ~7

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros
// when !copy (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool copy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(copy ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool copy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(copy ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stages record row `tri`'s first STAGE_CH floats (zeros for tri < 0)
// into dst, 16 bytes per copy: copies [q0, q0 + nq) of the four.
__device__ __forceinline__ void stage_row(float* dst, const float* rec,
                                          int rec_stride, int tri, int q0,
                                          int nq) {
  const bool ok = tri >= 0;
  const float* src = rec + (ok ? (size_t)tri * rec_stride : 0);
  for (int q = q0; q < q0 + nq; ++q) cp_async16(dst + 4 * q, src + 4 * q, ok);
}

// The 15 coverage coefficients and _ID of a staged candidate.
struct Staged {
  float co[STAGE_CH];
};

__device__ __forceinline__ Staged load_staged(const float* row) {
  const float4* q = reinterpret_cast<const float4*>(row);
  const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  return Staged{{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y,
                 q2.z, q2.w, q3.x, q3.y, q3.z, q3.w}};
}

// (key, index) as one unsigned word whose max is their lexicographic max;
// index -1 (the initial key) packs as 0.
__device__ __forceinline__ unsigned long long pack_best(int key, int idx) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)(idx + 1);
}

__device__ __forceinline__ int best_key(unsigned long long v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int best_idx(unsigned long long v) {
  return (int)(unsigned)(v & 0xffffffffu) - 1;
}

// Part [lo, hi) of a slot's `total` candidates that cluster rank `rank` of
// `csize` scans, and the number of parts in use (the same in every block
// of the cluster): parts of at least min_part candidates.
__device__ __forceinline__ int cluster_part(int total, int csize, int rank,
                                            int* lo, int* hi,
                                            int min_part = MIN_PART) {
  const int part = max((total + csize - 1) / csize, min_part);
  *lo = min(total, rank * part);
  *hi = min(total, *lo + part);
  return (total + part - 1) / part;
}

// Launches `kernel` on `grid` blocks of `block` threads in clusters of
// csize blocks (csize 1: a plain launch); returns the CUDA error code.
template <typename... P, typename... A>
int launch_clustered(void (*kernel)(P...), int grid, int block, int csize,
                     cudaStream_t st, A... args) {
  if (csize == 1) {
    kernel<<<grid, block, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Triangle id of candidate c of a scan that takes the overflow list's nb
// ids first, then pair_tri[start ...]; -1 (a zero record) out of range.
__device__ __forceinline__ int candidate_tri(const int* big_ids, int nb,
                                             const int* pair_tri,
                                             int pair_len, int start, int c) {
  if (c < nb) return big_ids[c];
  const int pi = start + (c - nb);
  return (pi >= 0 && pi < pair_len) ? pair_tri[pi] : -1;
}

// Barycentric weights e_k / (e0 + e1 + e2) of a winning record.
__device__ __forceinline__ void bary(const float* r, float px, float py,
                                     float* e, float* inv) {
  for (int k = 0; k < 3; ++k)
    e[k] = plane_eval(r[CH_A + k], r[CH_B + k], r[CH_C + k], px, py);
  const float esum = e[0] + e[1] + e[2];
  *inv = __frcp_rn(esum == 0.f ? 1.f : esum);
}

__device__ __forceinline__ float blend3(const float* r, int base, float b0,
                                        float b1, float b2) {
  return r[base] * b0 + r[base + 1] * b1 + r[base + 2] * b2;
}

constexpr int N_FIELDS = 19;  // _OUT_FIELDS of ops/fused.py

// The output planes of one pixel from its winning record (nullptr: no
// winner, every plane 0), in _OUT_FIELDS order.
__device__ inline void resolve_fields(const float* r, float px, float py,
                                      float* v) {
  if (r == nullptr) {
    for (int f = 0; f < N_FIELDS; ++f) v[f] = 0.f;
    return;
  }
  const float idf = r[CH_ID];
  const bool hit = idf >= 0.5f;
  float e[3], inv;
  bary(r, px, py, e, &inv);
  const float b0 = hit ? e[0] * inv : 0.f;
  const float b1 = hit ? e[1] * inv : 0.f;
  const float b2 = hit ? e[2] * inv : 0.f;
  const float zn = plane_eval(r[CH_ZC], r[CH_ZC + 1], r[CH_ZC + 2], px, py);
  const float wn = plane_eval(r[CH_WC], r[CH_WC + 1], r[CH_WC + 2], px, py);
  v[0] = hit ? zn * __frcp_rn(wn == 0.f ? 1.f : wn) : 0.f;  // depth
  v[1] = idf;
  v[2] = blend3(r, CH_U, b0, b1, b2);
  v[3] = blend3(r, CH_V, b0, b1, b2);
  for (int k = 0; k < 3; ++k) {
    v[4 + k] = blend3(r, CH_N + 3 * k, b0, b1, b2);
    v[7 + k] = blend3(r, CH_T + 3 * k, b0, b1, b2);
    v[10 + k] = blend3(r, CH_W + 3 * k, b0, b1, b2);
    v[13 + k] = blend3(r, CH_COL + 3 * k, b0, b1, b2);
  }
  v[16] = r[CH_MAT];
  v[17] = b0;
  v[18] = b1;
}

// Writes the depth key and the planes selected by `mask` of pixel p of
// slot s (fields are (popcount(mask), n_slots, npx)).
__device__ inline void write_pixel(const float* rec, int rec_stride,
                                   int best, int key, float px, float py,
                                   unsigned mask, int s, int n_slots, int npx,
                                   int p, int* zkey, float* fields) {
  const size_t o = (size_t)s * npx + p;
  zkey[o] = key;
  float v[N_FIELDS];
  resolve_fields(best >= 0 ? rec + (size_t)best * rec_stride : nullptr, px,
                 py, v);
  int slot = 0;
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    if ((mask >> f) & 1u) {
      fields[((size_t)slot * n_slots + s) * npx + p] = v[f];
      ++slot;
    }
  }
}

}  // namespace bb
