#!/usr/bin/env python3
"""Launch-shape variants of the shading kernels K2 (csrc/shade.cu) and K5
(csrc/gbuffer_shade.cu) and of the mip-block sampler K8
(csrc/mip_sample.cu), built from edited copies of ``csrc/`` and timed on
one NVIDIA GPU beside the committed kernels.

Run from the repository root: ``python3 tools/shade_variants.py [--only
k2k5|k8]``. It captures one K2 call of config 3 (1080p), one K5 call of
config 5 (4K), one K2 call of config 2 (720p cubes) and the K8 call of
config 2's ALBEDO view from ``chip_smoke.py``'s frames, and K8 on
``chip_smoke.mip_rho_stress`` inputs, then per call and per library
prints one JSON line: the kernel's device time (``chip_smoke.device_ms``,
20 launches; the committed library timed first and again last) and
whether its output equals the committed kernel's bit for bit. The
variants change no pixel's arithmetic:

- ``one_path``: every light list through the path the kernels keep for
  lists longer than their 64-light tile (restaged tile by tile, a barrier
  in the pixel loop), in place of the barrier-free path the frames' 2-3
  lights take;
- ``pixels2`` (K2, lists of at most 64 lights): each thread shades two
  adjacent pixels per step: float2 plane loads where both are covered
  (and the planes 8-byte aligned), the two light loops interleaved light
  by light; a pair with one miss takes the one-pixel path. At the
  committed kernels' four blocks a multiprocessor (64 registers a thread)
  and, as ``pixels2_regs128``, at two (128 registers);
- ``mip_div_mod`` (K8): every floor-mod by a division, without the
  in-range and one-wrap paths;
- ``mip_flat_grid`` (K8): a 1-D grid of warps, each finding its tile,
  row pair and columns by two integer divisions, in place of the 3-D
  grid;
- ``mip_tap_offsets`` (K8, and K2's mip group): every tap's address from
  the row and its own int offset, in place of two bases and immediate
  offsets;
- ``mip_lut`` (K8): each tap's value byte × (1/255) read from a
  256-entry shared-memory table, in place of a conversion and a multiply.

The edited sources and their builds go to ``build/variants/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ONE_PATH = [("shade.cu", "if (a.n_lights <= LIGHT_TILE)", "if (false)"),
            ("gbuffer_shade.cu", "if (n_lights <= LIGHT_TILE)",
             "if (false)")]

_PIXELS2_KERNEL = r"""
__device__ __forceinline__ void load_pixel2(const ShadeArgs& a, int i0,
                                            PixelPlanes& p0,
                                            PixelPlanes& p1) {
  auto ld = [&](const float* x, float& y0, float& y1) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(x + i0));
    y0 = q.x;
    y1 = q.y;
  };
  ld(a.u, p0.u, p1.u);
  ld(a.v, p0.v, p1.v);
  ld(a.wx, p0.w[0], p1.w[0]);
  ld(a.wy, p0.w[1], p1.w[1]);
  ld(a.wz, p0.w[2], p1.w[2]);
  ld(a.nx, p0.n[0], p1.n[0]);
  ld(a.ny, p0.n[1], p1.n[1]);
  ld(a.nz, p0.n[2], p1.n[2]);
  ld(a.tgx, p0.t[0], p1.t[0]);
  ld(a.tgy, p0.t[1], p1.t[1]);
  ld(a.tgz, p0.t[2], p1.t[2]);
  if (a.vis_plane != nullptr) {
    ld(a.vis_plane, p0.vis, p1.vis);
  } else {
    p0.vis = 1.f;
    p1.vis = 1.f;
  }
}

__device__ __forceinline__ bool aligned8(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 7) == 0;
}

template <bool RESIDENT, int S0, int S1, int S2, int S3>
__global__ void __launch_bounds__(SHADE_THREADS, S0 == GEN ? 1 : @BLOCKS@)
shade_kernel(const __grid_constant__ ShadeGroups g,
             const __grid_constant__ ShadeArgs a) {
  __shared__ PreparedLight tile[LIGHT_TILE];
  stage_lights(a.lp, min(a.n_lights, LIGHT_TILE), tile);
  const bool nm_on = *a.nm_enable != 0;
  const float vp[3] = {a.view_pos[0], a.view_pos[1], a.view_pos[2]};
  const bool tm_on = a.tonemap && *a.tm_enable != 0;
  const float expo = tm_on ? *a.exposure : 0.f;
  const bool qh = a.quantize_hdr != 0;
  const bool has_vis = a.vis_plane != nullptr;
  const float miss = hdr_epilogue(0.f, qh, tm_on, expo);
  const bool vec = aligned8(a.u) && aligned8(a.v) && aligned8(a.wx) &&
                   aligned8(a.wy) && aligned8(a.wz) && aligned8(a.nx) &&
                   aligned8(a.ny) && aligned8(a.nz) && aligned8(a.tgx) &&
                   aligned8(a.tgy) && aligned8(a.tgz) &&
                   (!has_vis || aligned8(a.vis_plane));
  // One covered pixel alone (the pair's other pixel is a miss).
  auto one = [&](int i, Surface& s, float& ao, float (&lo)[3]) {
    sampled_surface<S0, S1, S2, S3>(g, a, i, load_pixel(a, i), vp, nm_on,
                                    s, ao);
    ggx_lights(tile, a.n_lights, has_vis, s, lo);
  };
  auto put = [&](int i, bool hit, const Surface& s, float ao,
                 const float (&lo)[3]) {
    a.out_r[i] =
        hit ? hdr_epilogue(0.03f * s.alb[0] * ao + lo[0], qh, tm_on, expo)
            : miss;
    a.out_g[i] =
        hit ? hdr_epilogue(0.03f * s.alb[1] * ao + lo[1], qh, tm_on, expo)
            : miss;
    a.out_b[i] =
        hit ? hdr_epilogue(0.03f * s.alb[2] * ao + lo[2], qh, tm_on, expo)
            : miss;
  };
  const int stride = gridDim.x * blockDim.x;
  const int pairs = (a.n + 1) / 2;
  for (int base = blockIdx.x * blockDim.x; base < pairs; base += stride) {
    const int i0 = 2 * (base + threadIdx.x);
    if (i0 >= a.n) continue;
    const bool h0 = a.valid[i0] != 0;
    const bool h1 = i0 + 1 < a.n && a.valid[i0 + 1] != 0;
    Surface s0, s1;
    float ao0 = 0.f, ao1 = 0.f;
    float lo0[3] = {0.f, 0.f, 0.f}, lo1[3] = {0.f, 0.f, 0.f};
    if (h0 && h1) {
      PixelPlanes p0, p1;
      if (vec) {
        load_pixel2(a, i0, p0, p1);
      } else {
        p0 = load_pixel(a, i0);
        p1 = load_pixel(a, i0 + 1);
      }
      sampled_surface<S0, S1, S2, S3>(g, a, i0, p0, vp, nm_on, s0, ao0);
      sampled_surface<S0, S1, S2, S3>(g, a, i0 + 1, p1, vp, nm_on, s1, ao1);
      const GgxTerms t0 = ggx_terms(s0), t1 = ggx_terms(s1);
      for (int li = 0; li < a.n_lights; ++li) {
        ggx_light(tile[li], has_vis, s0, t0, lo0);
        ggx_light(tile[li], has_vis, s1, t1, lo1);
      }
    } else if (h0) {
      one(i0, s0, ao0, lo0);
    } else if (h1) {
      one(i0 + 1, s1, ao1, lo1);
    }
    put(i0, h0, s0, ao0, lo0);
    if (i0 + 1 < a.n) put(i0 + 1, h1, s1, ao1, lo1);
  }
}

"""


def pixels2(blocks: int) -> list:
    """The two-pixel K2 with at least ``blocks`` blocks a multiprocessor
    (the fixed layouts; 4 caps a thread at 64 registers, 2 at 128)."""
    return [
        ("shade.cu", ("// Four blocks a multiprocessor",
                      "template <bool RESIDENT, int S0, int S1, int S2, "
                      "int S3>\ncudaError_t launch_shade"),
         _PIXELS2_KERNEL.replace("@BLOCKS@", str(blocks))),
        ("shade.cu", "resident_grid(kernel, SHADE_THREADS, a.n, wave)",
         "resident_grid(kernel, SHADE_THREADS, (a.n + 1) / 2, wave)"),
    ]


_FLAT_GRID = r"""  const int segs = a.tile_w >> 4;
  const int per_tile = (a.tile_h >> 1) * segs;  // warps a tile
  const int wid = blockIdx.x * (MIP_THREADS / 32) + (threadIdx.x >> 5);
  const int tile = wid / per_tile;
  if (tile >= a.nt) return;
  const int r = wid - tile * per_tile;
  const int rp = r / segs;
  const int y = 2 * rp + (lane >> 4);
  const int x = 16 * (r - rp * segs) + (lane & 15);
"""


VARIANTS = {"one_path": ONE_PATH, "pixels2": pixels2(4),
            "pixels2_regs128": pixels2(2)}
_TAP_OFFSETS = r"""  auto ld = [&](int o) { return (float)__ldg(row + o) * INV255; };
  float own = ld(t.c00 + k) * t.w00;
  own = own + ld(t.c00 + cs + k) * t.w01;
  own = own + ld(t.c00 + 5 * cs + k) * t.w10;
  own = own + ld(t.c00 + 6 * cs + k) * t.w11;
  float par = (t.x0 && t.y0) ? ld(t.p00 + k) * t.v00 : 0.f;
  par = par + ((t.x1 && t.y0) ? ld(t.p00 + cs + k) * t.v01 : 0.f);
  par = par + ((t.x0 && t.y1) ? ld(t.p00 + 4 * cs + k) * t.v10 : 0.f);
  par = par + ((t.x1 && t.y1) ? ld(t.p00 + 5 * cs + k) * t.v11 : 0.f);
"""

_LUT_BLEND = r"""  for (int k = 0; k < CS; ++k) {
    const uint8_t* ch = row + t.c00 + k;
    const uint8_t* pa = row + t.p00 + k;
    auto ld = [&](const uint8_t* p) { return lut[__ldg(p)]; };
    float own = ld(ch) * t.w00;
    own = own + ld(ch + CS) * t.w01;
    own = own + ld(ch + 5 * CS) * t.w10;
    own = own + ld(ch + 6 * CS) * t.w11;
    float par = (t.x0 && t.y0) ? ld(pa) * t.v00 : 0.f;
    par = par + ((t.x1 && t.y0) ? ld(pa + CS) * t.v01 : 0.f);
    par = par + ((t.x0 && t.y1) ? ld(pa + 4 * CS) * t.v10 : 0.f);
    par = par + ((t.x1 && t.y1) ? ld(pa + 5 * CS) * t.v11 : 0.f);
    out[k * n] = own * t.omfr + par * t.frac;
  }"""

MIP_VARIANTS = {
    "mip_div_mod": [("shading.cuh", ("  if ((unsigned)a < (unsigned)b)",
                                     "  const int r = a % b;"), "")],
    "mip_flat_grid": [
        ("mip_sample.cu", ("  const int tile = blockIdx.x;",
                           "  const int npx"), _FLAT_GRID),
        ("mip_sample.cu", "dim3(a.nt, a.tile_h / 2, runs)",
         "(int)(((long long)a.nt * (a.tile_h / 2) * (a.tile_w / 16) + 7)"
         " / 8)")],
    "mip_tap_offsets": [("shading.cuh",
                         ("  const uint8_t* ch = row + t.c00 + k;",
                          "  return own * t.omfr + par * t.frac;"),
                         _TAP_OFFSETS)],
    "mip_lut": [
        ("mip_sample.cu", "  const int lane = threadIdx.x & 31;\n",
         "  __shared__ float lut[256];  // MIP_THREADS == 256\n"
         "  lut[threadIdx.x] = (float)threadIdx.x * INV255;\n"
         "  __syncthreads();\n  const int lane = threadIdx.x & 31;\n"),
        ("mip_sample.cu",
         "  for (int k = 0; k < CS; ++k) out[k * n] = "
         "mip_channel(row, CS, t, k);", _LUT_BLEND)]}


def edit(text: str, old, new: str) -> str:
    """Replace ``old`` (a string, or a (start, end) pair: the text from
    start up to end) once; it must be there."""
    if isinstance(old, tuple):
        i = text.index(old[0])
        j = text.index(old[1], i)
        return text[:i] + new + text[j:]
    if old not in text:
        raise ValueError(f"variant anchor not found: {old!r}")
    return text.replace(old, new, 1)


def variant_library(name: str, edits):
    """The kernel library built from ``csrc/`` with ``edits`` applied."""
    from bibim_tpu_torch import _build

    root = ROOT / "build" / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(_build.CSRC, root / "csrc")
    for fname, old, new in edits:
        f = root / "csrc" / fname
        f.write_text(edit(f.read_text(), old, new))
    spec = importlib.util.spec_from_file_location(
        f"variant_build_{name}", ROOT / "bibim_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CSRC = root / "csrc"
    mod.BUILD_DIR = root / "build"
    mod.build(verbose=True)
    lib = mod.library()
    _build._declare(lib)  # the committed Groups type in the signatures
    return lib, mod.build_log


def main() -> int:
    import torch

    import chip_smoke as cs
    from bibim_tpu_torch import _build
    from bibim_tpu_torch.ops import shading as sh
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.pipeline import KERNELS, render_frame

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k2k5", "k8"),
                    help="the K2 / K5 or the K8 variants alone")
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        print("shade_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    committed = _build.library()
    libs = {"committed": committed}
    todo = {**({} if only == "k8" else VARIANTS),
            **({} if only == "k2k5" else MIP_VARIANTS)}
    for name, edits in todo.items():
        libs[name], log = variant_library(name, edits)
        usage = {k: v for k, v in cs.ptxas_usage(log).items()
                 if "shade" in k or "mip_block" in k}
        print(f"ptxas {name}: " + json.dumps(usage), flush=True)

    def capture(frames):
        calls: dict = {}
        for args, kw in frames:
            render_frame(*args, **kw,
                         kernels=cs.capture_kernels(KERNELS, calls))
        torch.cuda.synchronize()
        return calls

    rows = []
    scene2, mats2, proj2, fp2, s2 = cs.cube_inputs(dev)
    frames2 = cs.c2_frames(s2, proj2, dev)
    if only != "k8":
        k2 = ["committed", *VARIANTS]
        scene, mats, overlay, proj, fp, settings = cs.build_inputs(dev)
        c3 = capture([((scene, cs.view_block(0.0, proj, dev), fp, mats,
                        overlay, settings), {})])
        s5 = cs.build_inputs(dev, cs.C5_WIDTH, cs.C5_HEIGHT, cs.C5_CAPS,
                             enable_shadows=True, shadow_fit_batches=(0,),
                             enable_ibl=True)
        c5 = capture([((s5[0], cs.view_block(0.0, s5[3], dev), s5[4],
                        s5[1], s5[2], s5[5]),
                       dict(ibl=make_ibl_sh(device=dev)))])
        _, vb2, st2 = frames2[0]
        c2 = capture([((scene2, vb2, fp2, mats2, None, st2), {})])
        rows += [("config 3 K2", sh.shade_sampled, c3["shade"][0],
                  "bb::shade_kernel", k2),
                 ("config 5 K5", sh.shade_tonemap, c5["shade_gbuffer"][0],
                  "gbuffer_shade_kernel", ["committed", "one_path"]),
                 ("config 2 K2", sh.shade_sampled, c2["shade"][0],
                  "bb::shade_kernel", k2)]
    if only != "k2k5":
        k8 = ["committed", *MIP_VARIANTS]
        _, vba, sta = frames2[len(cs.C2_CAMERA_Z)]  # the ALBEDO view
        ca = capture([((scene2, vba, fp2, mats2, None, sta), {})])
        call = ca["sample_mip_block"][0]
        stress = cs.mip_rho_stress(call[0][0], 900, dev)
        rows += [("config 2 ALBEDO view K8", tq.sample_mip_block_kernel,
                  call, "mip_block_kernel", k8),
                 ("K8 rho stress", tq.sample_mip_block_kernel,
                  ((call[0][0], *stress), {}, None), "mip_block_kernel",
                  k8)]
    for label, fn, (args, kw, _), match, names in rows:
        _build._lib = committed
        want = fn(*args, **kw)
        if isinstance(want, dict):  # K8: slot → plane
            want = list(want.values())
        row = {}
        for name in names + ["committed"]:
            _build._lib = libs[name]
            got = fn(*args, **kw)
            if isinstance(got, dict):
                got = list(got.values())
            torch.cuda.synchronize()
            key = name if name not in row else "committed_again"
            row[key] = dict(
                kernel_ms=cs.device_ms(lambda: fn(*args, **kw), 20, match),
                equal=all(torch.equal(g, w) for g, w in zip(got, want)))
        _build._lib = committed
        print(f"{label}: " + json.dumps(row), flush=True)
        if not all(r["equal"] for r in row.values()):
            raise AssertionError(f"{label}: a variant changed the output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
