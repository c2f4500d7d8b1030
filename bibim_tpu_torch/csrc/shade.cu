// K2 — fused sampled shade: material sampling + normal map + fp16 G-buffer
// + GGX lighting, and optionally the frame's fp16 + tone-map tail.
//
// Replaces bibim_tpu/ops/shading_pallas.py:_sampled_kernel (launched by
// shade_sampled_pallas) together with the XLA-side block_prep / small_prep
// that feed it at pair level 0.
//
// What bounds it on an H100: bytes. Per valid pixel it reads 11 float
// planes (plus the shadow visibility plane when given), one block-table row
// and one quad-table row, and writes 3 floats, against a light loop of
// IEEE divisions and square roots (-fmad=false). It runs at 2.5-4x the
// time those bytes need. Timed in parts (chip_smoke.py: no lights, every
// pixel a miss): the light loop, instruction issue with no memory traffic,
// takes about two fifths of the time on configs 3 and 4, and it does not
// overlap the dependent gathers (planes, then table rows), which run at
// about half of HBM's rate; two pixels a thread with float2 plane loads
// (tools/shade_variants.py) measured slower. The TPU version
// materialises the gathered block rows transposed to (NT, 128, NPX)
// through device memory (~265 MB at 1080p) because Mosaic cannot gather
// per pixel; here each thread reads its rows by index straight from the
// tables. The design spends no instruction that the output does not need:
// - valid first: a miss reads its coverage byte and writes the miss value,
//   nothing else (every input plane may hold garbage there). Listing a
//   block's covered pixels in shared memory first, so that no lane idles
//   at a miss, measured slower on config 3;
// - the binding's group layout (kind, present channels, slots) is a
//   template argument for the layouts the configurations bind, so the slot
//   array and the per-group channel values live in registers; other
//   bindings take the generic instantiation, which reads the layout from
//   ShadeGroups at compile-time offsets and selects slots by predicate,
//   again without a runtime-indexed local array;
// - texel rows are read as words: a block-table tap's cpad channels as
//   cpad/4 aligned 4-byte words, a quad row (4 taps x cpad) as 16-byte
//   vectors, unpacked in registers (mip-block rows, channel stride 3 on
//   config 2, keep byte loads);
// - the light rows are prepared by the block into a shared-memory tile
//   (shading.cuh stage_lights, for_light_tiles), and a grid-stride loop
//   over at most one resident wave of blocks amortises that over many
//   pixels;
// - with quantize_hdr / tonemap the kernel writes the LDR planes the frame
//   needs next (shading.cuh hdr_epilogue), saving the torch tail's passes.
// Every pixel's arithmetic is operation for operation that of the
// reference's order, so the output does not depend on the layout path.
// Trilinear mip bindings (config 2) add two group kinds fed by per-pixel
// planes computed as torch ops: the mip-block row with the 41-tap blend K8
// runs and material-routed small-table rows.
#include "shading.cuh"

namespace bb {

constexpr int SHADE_THREADS = 256;

// A group's layout as one int: kind << 10 | mask of the slots it fills
// (its channels are the set bits in slot order). GEN: read the group from
// ShadeGroups at run time; NONE: no such group.
constexpr int GEN = -1;
constexpr int NONE = -2;

__host__ __device__ constexpr int popc10(int m) {
  return m == 0 ? 0 : (m & 1) + popc10(m >> 1);
}
// Slot of channel j: the j-th set bit of mask m.
__host__ __device__ constexpr int nth_slot(int m, int j) {
  return m == 0 ? 0
                : ((m & 1) ? (j == 0 ? 0 : 1 + nth_slot(m >> 1, j - 1))
                           : 1 + nth_slot(m >> 1, j));
}
__host__ __device__ constexpr int layout_spec(int kind, int mask) {
  return kind << 10 | mask;
}

// Group layouts of the bindings the configurations use; bb_shade picks
// one from ShadeGroups (shade_layout).
// Configs 3 and 4 (and the CPU tests' maps): a 16^2 quad table of albedo,
// normal and height, a 2048^2 block table of metallic, roughness and ao.
constexpr int QUAD_ALB_NRM_H = layout_spec(1, 0x23F);
constexpr int BLOCK_MRA = layout_spec(0, 0x1C0);
// Config 2: the albedo mip-block rows and the routed 4x4 neutral maps.
constexpr int MIP_ALB = layout_spec(2, 0x007);
constexpr int ROUTED_NRM_MRAH = layout_spec(3, 0x3F8);

template <int V>
struct IC {
  static constexpr int value = V;
};

template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(IC<B>{});
    static_for<B + 1, E>(f);
  }
}

// Group GI of layout S: compile-time constants where S is fixed, the
// ShadeGroups fields otherwise.
template <int S, int GI>
struct Grp {
  static constexpr bool fixed = S >= 0;
  static constexpr int kind_c = fixed ? S >> 10 : -1;
  static constexpr int np_c = fixed ? popc10(S & 1023) : 0;
  static __device__ __forceinline__ int kind(const ShadeGroups& g) {
    if constexpr (fixed) return kind_c;
    else return g.kind[GI];
  }
  static __device__ __forceinline__ int np(const ShadeGroups& g) {
    if constexpr (fixed) return np_c;
    else return g.n_present[GI];
  }
  // Channel stride of the mip-block rows (len(present)).
  static __device__ __forceinline__ int cs(const ShadeGroups& g) {
    if constexpr (fixed) return np_c;
    else return g.cpad[GI];
  }
  // Channel J's value into its slot.
  template <int J>
  static __device__ __forceinline__ void put(const ShadeGroups& g, float x,
                                             float (&slots)[N_SLOTS]) {
    if constexpr (fixed) {
      if constexpr (J < np_c) {
        constexpr int slot = nth_slot(S & 1023, J);
        slots[slot] = x;
      }
    } else {
      const int s = g.slot[GI][J];
      static_for<0, N_SLOTS>([&](auto k) {
        if (s == decltype(k)::value) slots[decltype(k)::value] = x;
      });
    }
  }
};

// NW aligned 4-byte words from p (16-byte vectors where NW allows).
template <int NW>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
    static_for<0, NW / 4>([&](auto q) {
      constexpr int Q = decltype(q)::value;
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + Q);
      w[4 * Q] = x.x;
      w[4 * Q + 1] = x.y;
      w[4 * Q + 2] = x.z;
      w[4 * Q + 3] = x.w;
    });
  } else if constexpr (NW == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_for<0, NW>([&](auto q) {
      w[decltype(q)::value] =
          __ldg(reinterpret_cast<const uint32_t*>(p) + decltype(q)::value);
    });
  }
}

// Byte B of a word array, as tap() converts it: byte * (1/255).
template <int B, int NW>
__device__ __forceinline__ float word_tap(const uint32_t (&w)[NW]) {
  return (float)((w[B >> 2] >> (8 * (B & 3))) & 0xffu) * INV255;
}

// Channels J < np of a block-table row (kind 0, channel stride CPAD): the
// 4 live taps of the 5x5 neighbourhood, blend_block's order.
template <int CPAD>
__device__ __forceinline__ void sample_block(const ShadeGroups& g, int gi,
                                             float u, float v, int np,
                                             float (&acc)[N_SLOTS]) {
  constexpr int NW = CPAD / 4;
  const int h = g.h[gi], w = g.w[gi];
  int x0i, y0i;
  float tx, ty;
  footprint(u, v, h, w, &x0i, &y0i, &tx, &ty);
  const uint8_t* row =
      g.tab[gi] + (size_t)((y0i / 4) * (w / 4) + (x0i / 4)) * g.row_bytes[gi];
  const int t00 = ((y0i % 4) * 5 + (x0i % 4)) * CPAD;
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
      float a = word_tap<J>(q00) * w00;
      a = a + word_tap<J>(q01) * w01;
      a = a + word_tap<J>(q10) * w10;
      a = a + word_tap<J>(q11) * w11;
      acc[J] = a;
    }
  });
}

// Channels J < np of a quad row [t00 | t01 | t10 | t11] x CPAD (kinds 1
// and 3), blend_quad's order.
template <int CPAD>
__device__ __forceinline__ void sample_quad(const uint8_t* row, float tx,
                                            float ty, int np,
                                            float (&acc)[N_SLOTS]) {
  uint32_t q[CPAD];  // 4 * CPAD bytes
  load_words<CPAD>(row, q);
  const float omtx = 1.f - tx, omty = 1.f - ty;
  static_for<0, (CPAD < N_SLOTS ? CPAD : N_SLOTS)>([&](auto j) {
    constexpr int J = decltype(j)::value;
    if (J < np) {
      const float top = word_tap<J>(q) * omtx + word_tap<CPAD + J>(q) * tx;
      const float bot =
          word_tap<2 * CPAD + J>(q) * omtx + word_tap<3 * CPAD + J>(q) * tx;
      acc[J] = top * omty + bot * ty;
    }
  });
}

// Run body(IC<cpad>) for the group's channel stride: a constant for a
// fixed layout, else the stride ShadeGroups holds (ceil4 of <= 10
// channels: 4, 8 or 12).
template <class G, class F>
__device__ __forceinline__ void with_cpad(const ShadeGroups& g, int gi,
                                          F&& body) {
  if constexpr (G::fixed) {
    body(IC<(G::np_c + 3) / 4 * 4>{});
  } else {
    const int c = g.cpad[gi];
    if (c == 4) body(IC<4>{});
    else if (c == 8) body(IC<8>{});
    else body(IC<12>{});
  }
}

// Samples of group GI (layout S) at pixel i (of n) into the slots.
template <int S, int GI>
__device__ __forceinline__ void sample_group(const ShadeGroups& g, int i,
                                             int n, float u, float v,
                                             float (&slots)[N_SLOTS]) {
  if constexpr (S != NONE) {
    using G = Grp<S, GI>;
    if (!G::fixed && GI >= g.n) return;
    const int kind = G::kind(g);
    const int np = G::np(g);
    float acc[N_SLOTS];
    static_for<0, N_SLOTS>([&](auto j) { acc[decltype(j)::value] = 0.f; });
    if (kind == 2) {
      MipGeom geom;
      const int r = load_mip_geom(g.gi[GI], g.gf[GI], i, n, &geom);
      const uint8_t* row = g.tab[GI] + (size_t)r * g.row_bytes[GI];
      const MipTaps t = mip_taps(G::cs(g), geom);
      static_for<0, N_SLOTS>([&](auto j) {
        constexpr int J = decltype(j)::value;
        if (J < np) acc[J] = mip_channel(row, t, J);
      });
    } else if (kind == 3) {
      // A row outside the table samples 0 (the reference's one-hot
      // select).
      const int r = g.gi[GI][i];
      if (r >= 0 && r < g.rows[GI]) {
        const uint8_t* row = g.tab[GI] + (size_t)r * g.row_bytes[GI];
        const float tx = g.gf[GI][i], ty = g.gf[GI][n + i];
        with_cpad<G>(g, GI, [&](auto c) {
          sample_quad<decltype(c)::value>(row, tx, ty, np, acc);
        });
      }
    } else if (kind == 0) {
      with_cpad<G>(g, GI, [&](auto c) {
        sample_block<decltype(c)::value>(g, GI, u, v, np, acc);
      });
    } else {
      int x0i, y0i;
      float tx, ty;
      footprint(u, v, g.h[GI], g.w[GI], &x0i, &y0i, &tx, &ty);
      const uint8_t* row =
          g.tab[GI] + (size_t)(y0i * g.w[GI] + x0i) * g.row_bytes[GI];
      with_cpad<G>(g, GI, [&](auto c) {
        sample_quad<decltype(c)::value>(row, tx, ty, np, acc);
      });
    }
    static_for<0, N_SLOTS>([&](auto j) {
      constexpr int J = decltype(j)::value;
      if (J < np) G::template put<J>(g, acc[J], slots);
    });
  }
}

struct ShadeArgs {
  const float *u, *v, *wx, *wy, *wz, *nx, *ny, *nz, *tgx, *tgy, *tgz;
  const uint8_t* valid;    // the bool plane's bytes
  const float* vis_plane;  // or NULL
  const float* lp;         // (max(L, 1), 16) light rows
  int n_lights;
  const float* view_pos;
  const int* nm_enable;
  int quantize;           // the G-buffer's fp16 round trip
  const float* exposure;       // tail: NULL when tonemap is 0
  const int* tm_enable;
  int quantize_hdr, tonemap;
  int n;
  float *out_r, *out_g, *out_b;
};

// The per-pixel input planes at pixel i.
struct PixelPlanes {
  float u, v, w[3], n[3], t[3], vis;
};

__device__ __forceinline__ PixelPlanes load_pixel(const ShadeArgs& a,
                                                  int i) {
  PixelPlanes p;
  p.u = a.u[i];
  p.v = a.v[i];
  p.w[0] = a.wx[i];
  p.w[1] = a.wy[i];
  p.w[2] = a.wz[i];
  p.n[0] = a.nx[i];
  p.n[1] = a.ny[i];
  p.n[2] = a.nz[i];
  p.t[0] = a.tgx[i];
  p.t[1] = a.tgy[i];
  p.t[2] = a.tgz[i];
  p.vis = a.vis_plane != nullptr ? a.vis_plane[i] : 1.f;
  return p;
}

// Surface of covered pixel i from its planes: the groups' samples into the
// slots, the normal map, the G-buffer's fp16 round trip; ``ao`` out.
template <int S0, int S1, int S2, int S3>
__device__ __forceinline__ void sampled_surface(const ShadeGroups& g,
                                                const ShadeArgs& a, int i,
                                                const PixelPlanes& p,
                                                const float (&vp)[3],
                                                bool nm_on, Surface& s,
                                                float& ao) {
  float slots[N_SLOTS];
  static_for<0, N_SLOTS>([&](auto k) { slots[decltype(k)::value] = 0.f; });
  sample_group<S0, 0>(g, i, a.n, p.u, p.v, slots);
  sample_group<S1, 1>(g, i, a.n, p.u, p.v, slots);
  sample_group<S2, 2>(g, i, a.n, p.u, p.v, slots);
  sample_group<S3, 3>(g, i, a.n, p.u, p.v, slots);

  // Normal map (gbuffer.frag): N = TBN * (2*tap - 1), B = cross(N, T).
  const float* nrm = p.n;
  const float* tan = p.t;
  const float bit[3] = {nrm[1] * tan[2] - nrm[2] * tan[1],
                        nrm[2] * tan[0] - nrm[0] * tan[2],
                        nrm[0] * tan[1] - nrm[1] * tan[0]};
  const float mx = slots[3] * 2.f - 1.f;
  const float my = slots[4] * 2.f - 1.f;
  const float mz = slots[5] * 2.f - 1.f;

  // Deferred G-buffer: the RGBA16F round trip (the pixel is covered, so
  // the miss clear keeps every value).
  auto mq = [&](float x) { return a.quantize ? q16(x) : x; };
  for (int c = 0; c < 3; ++c) s.world[c] = mq(p.w[c]);
  for (int c = 0; c < 3; ++c) {
    const float mapped = tan[c] * mx + bit[c] * my + nrm[c] * mz;
    s.n[c] = mq(nm_on ? mapped : nrm[c]);
    s.alb[c] = mq(slots[c]);
  }
  s.met = mq(slots[6]);
  s.rough = mq(slots[7]);
  ao = mq(slots[8]);
  normalize3(s.n);
  for (int c = 0; c < 3; ++c) s.v[c] = vp[c] - s.world[c];
  normalize3(s.v);
  for (int c = 0; c < 3; ++c)
    s.f0[c] = 0.04f * (1.f - s.met) + s.alb[c] * s.met;
  s.vis = p.vis;
}

// The block's pixels, grid-stride; RESIDENT: the lights fit the tile and
// are staged (for_light_tiles).
template <bool RESIDENT, int S0, int S1, int S2, int S3>
__device__ __forceinline__ void shade_pixels(const ShadeGroups& g,
                                             const ShadeArgs& a,
                                             PreparedLight* tile) {
  const bool nm_on = *a.nm_enable != 0;
  const float vp[3] = {a.view_pos[0], a.view_pos[1], a.view_pos[2]};
  const bool tm_on = a.tonemap && *a.tm_enable != 0;
  const float expo = tm_on ? *a.exposure : 0.f;
  const bool qh = a.quantize_hdr != 0;
  const bool has_vis = a.vis_plane != nullptr;
  const float miss = hdr_epilogue(0.f, qh, tm_on, expo);
  const int stride = gridDim.x * blockDim.x;
  // The trip count is the block's, not the thread's: for_light_tiles may
  // synchronise the block.
  for (int base = blockIdx.x * blockDim.x; base < a.n; base += stride) {
    const int i = base + threadIdx.x;
    const bool hit = i < a.n && a.valid[i] != 0;
    Surface s;
    float ao = 0.f;
    if (hit)
      sampled_surface<S0, S1, S2, S3>(g, a, i, load_pixel(a, i), vp, nm_on,
                                      s, ao);
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
    a.out_r[i] = hdr_epilogue(0.03f * s.alb[0] * ao + lo[0], qh, tm_on, expo);
    a.out_g[i] = hdr_epilogue(0.03f * s.alb[1] * ao + lo[1], qh, tm_on, expo);
    a.out_b[i] = hdr_epilogue(0.03f * s.alb[2] * ao + lo[2], qh, tm_on, expo);
  }
}

// Four blocks a multiprocessor (at most 64 registers) for the fixed
// layouts; the generic instantiation takes one, so that ptxas can go past
// 64 registers there instead of spilling. RESIDENT and the tiled light path
// are separate kernels, so that neither's registers constrain the other.
template <bool RESIDENT, int S0, int S1, int S2, int S3>
__global__ void __launch_bounds__(SHADE_THREADS, S0 == GEN ? 1 : 4)
shade_kernel(const __grid_constant__ ShadeGroups g,
             const __grid_constant__ ShadeArgs a) {
  __shared__ PreparedLight tile[LIGHT_TILE];
  if constexpr (RESIDENT) stage_lights(a.lp, a.n_lights, tile);
  shade_pixels<RESIDENT, S0, S1, S2, S3>(g, a, tile);
}

template <bool RESIDENT, int S0, int S1, int S2, int S3>
cudaError_t launch_shade(const ShadeGroups& g, const ShadeArgs& a,
                         cudaStream_t stream) {
  static int wave[MAX_DEVICES];
  auto kernel = shade_kernel<RESIDENT, S0, S1, S2, S3>;
  const int blocks = resident_grid(kernel, SHADE_THREADS, a.n, wave);
  kernel<<<blocks, SHADE_THREADS, 0, stream>>>(g, a);
  return cudaGetLastError();
}

template <int S0, int S1, int S2, int S3>
cudaError_t launch_layout(const ShadeGroups& g, const ShadeArgs& a,
                          cudaStream_t stream) {
  if (a.n_lights <= LIGHT_TILE)
    return launch_shade<true, S0, S1, S2, S3>(g, a, stream);
  return launch_shade<false, S0, S1, S2, S3>(g, a, stream);
}

// Group k's layout as the fixed instantiations spell it, or GEN where it
// cannot be one: slots that do not ascend (a fixed layout puts channel j
// in the j-th set bit of its mask) or a channel stride of another rule.
inline int group_spec(const ShadeGroups& g, int k) {
  const int np = g.n_present[k];
  int mask = 0, prev = -1;
  for (int j = 0; j < np; ++j) {
    const int slot = g.slot[k][j];
    if (slot <= prev || slot >= N_SLOTS) return GEN;
    mask |= 1 << slot;
    prev = slot;
  }
  const int cpad = g.kind[k] == 2 ? np : (np + 3) / 4 * 4;
  return g.cpad[k] == cpad ? layout_spec(g.kind[k], mask) : GEN;
}

// 1: QUAD_ALB_NRM_H + BLOCK_MRA; 2: MIP_ALB + ROUTED_NRM_MRAH; 0: generic.
inline int shade_layout(const ShadeGroups& g) {
  if (g.n != 2) return 0;
  const int s0 = group_spec(g, 0), s1 = group_spec(g, 1);
  if (s0 == QUAD_ALB_NRM_H && s1 == BLOCK_MRA) return 1;
  if (s0 == MIP_ALB && s1 == ROUTED_NRM_MRAH) return 2;
  return 0;
}

}  // namespace bb

// The instantiation bb_shade runs for ``g`` (0: the generic one).
extern "C" int bb_shade_layout(const ShadeGroups* g) {
  return bb::shade_layout(*g);
}

// generic: run the generic instantiation whatever the layout (tests and
// measurement).
extern "C" int bb_shade(const ShadeGroups* g, const float* u, const float* v,
                        const float* wx, const float* wy, const float* wz,
                        const float* nx, const float* ny, const float* nz,
                        const float* tgx, const float* tgy, const float* tgz,
                        const uint8_t* valid, const float* vis_plane,
                        const float* lparams, int n_lights,
                        const float* view_pos, const int* nm_enable,
                        int quantize,
                        const float* exposure, const int* tm_enable,
                        int quantize_hdr, int tonemap, int generic, int n,
                        float* out_r, float* out_g, float* out_b,
                        void* stream) {
  using namespace bb;
  if (n <= 0) return (int)cudaGetLastError();
  const ShadeArgs a{u, v, wx, wy, wz, nx, ny, nz, tgx, tgy, tgz, valid,
                    vis_plane, lparams, n_lights, view_pos, nm_enable,
                    quantize, exposure, tm_enable,
                    quantize_hdr, tonemap, n, out_r, out_g, out_b};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (generic ? 0 : shade_layout(*g)) {
    case 1:
      return (int)launch_layout<QUAD_ALB_NRM_H, BLOCK_MRA, NONE, NONE>(*g, a,
                                                                        s);
    case 2:
      return (int)launch_layout<MIP_ALB, ROUTED_NRM_MRAH, NONE, NONE>(*g, a,
                                                                       s);
    default:
      return (int)launch_layout<GEN, GEN, GEN, GEN>(*g, a, s);
  }
}
