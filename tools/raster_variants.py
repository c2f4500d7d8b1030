#!/usr/bin/env python3
"""Design variants of the early-z raster K9 (csrc/raster_earlyz.cu), the
fine-subtile raster K11 (csrc/raster_fine.cu) and the overlay composite K4
(csrc/raster.cu ``overlay_kernel``), built from edited copies of
``csrc/`` and timed on one NVIDIA GPU beside the committed kernels.

Run from the repository root: ``python3 tools/raster_variants.py
[--only k9k11|k4]``. For K9 and K11 it
builds ``chip_smoke.py``'s config-4 frames (64 instances, 1920×1080, the
three views, each culled on the host and autotuned) in the early-z and
fine-bin modes, captures every K9 call (every pass) and every K11 call
(pass 0), checks the committed kernels against their plain versions on
each (``torch.equal``), then per frame and per library prints one JSON
line: the summed kernel ms of the frame's launches (``chip_smoke.graph_ms``
per launch; the committed library timed first and again last), whether
every output equals the committed kernel's bit for bit, and for K9 the
share of window chunks its break skipped over the frame's launches
(``stats``). The variants change no pixel's result:

- ``k9_no_edge_skip``: K9 computes every candidate's depth planes and
  reciprocal at every pixel and masks the key by the edge test afterwards
  (the full test of the first K9 kernel);
- ``k9_stage32`` / ``k9_stage64`` / ``k9_stage128``: K9 rounds (and
  break tests) of 32 / 64 / 128 candidates, each size but the committed
  one;
- ``k11_no_corner_cull``: K11 tests every candidate of a round, also those
  whose edge function is negative at the subtile's four corner pixels;
- ``k11_cull_overflow_only``: K11's corner test on the overflow list only,
  not on the fine windows;
- ``k11_no_edge_skip``: K11 likewise for every candidate the corner test
  leaves.

For K4 it captures chip_smoke.py's overlay calls with the most live slots
(config-3 light spheres, config-3 HUD, config-5 light spheres), and per
call and library prints the kernel ms (``chip_smoke.graph_ms``; the
committed library first and last) and whether the composite equals the
committed kernel's bit for bit:

- ``k4_no_edge_skip``: every candidate's depth planes and reciprocal at
  every pixel, the key masked by the edge test (K4's earlier test,
  ``cover_key``); it edits the scan K4 shares with K1 and K10, which are
  not timed here;
- ``k4_no_cp_async``: the rounds' records staged by plain 16-byte loads
  and shared-memory stores instead of cp.async;
- ``k4_min_part16`` / ``32`` / ``64``: cluster parts of at least 16 / 32
  / 64 candidates instead of 8 (``OVERLAY_MIN_PART``; 64 is K1's);

and two that change the result, timed only, to find what the time of a
call with a few short windows is made of:

- ``k4_diag_empty``: every block leaves at once (the launch of the fixed
  grid alone);
- ``k4_diag_no_scan``: each live slot's setup and write-back without its
  candidate loop.

The split sizes (K9's and K4's cluster, K11's warps a subtile, K4's
cluster count) are knobs of the committed wrappers: ``chip_smoke.py``
prints every launch at each.
The edited sources and their builds go to ``build/variants/`` (git-ignored).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# Every candidate's depth planes and reciprocal at every pixel, the key
# masked by the edge test afterwards (the first K9 / K11 kernels' full
# test).
DEPTH = "key = depth_key(co, px[k], py[k], &ok);"


def no_edge_skip(fname: str) -> list:
    return [(fname, "if (__any_sync(0xffffffffu, any_in)) {", "if (true) {"),
            (fname, "if (in[k]) {", "if (true) {"),
            (fname, DEPTH, DEPTH + " ok &= in[k]; key = ok ? key : MISS_KEY;")]


STAGE = "constexpr int EZ_STAGE = {};"
EZ_STAGE = int(re.search(
    STAGE.format(r"(\d+)"),
    (ROOT / "bibim_tpu_torch" / "csrc" / "raster_earlyz.cu").read_text())[1])

VARIANTS = {
    "k9_no_edge_skip": ("raster_earlyz", no_edge_skip("raster_earlyz.cu")),
    **{f"k9_stage{n}": ("raster_earlyz", [(
        "raster_earlyz.cu", STAGE.format(EZ_STAGE), STAGE.format(n))])
       for n in (32, 64, 128) if n != EZ_STAGE},
    "k11_no_corner_cull": ("raster_fine", [(
        "raster_fine.cu", "    if (cull) {", "    if (false) {")]),
    # The corner test on the overflow list only: a flag the fine windows'
    # scans clear.
    "k11_cull_overflow_only": ("raster_fine", [
        ("raster_fine.cu", "  bool cull;\n", "  bool cull;\n  bool corner = true;\n"),
        ("raster_fine.cu", "    if (cull) {", "    if (cull && corner) {"),
        ("raster_fine.cu", "      held = g;\n",
         "      held = g;\n      sc.corner = false;\n")]),
    "k11_no_edge_skip": ("raster_fine", no_edge_skip("raster_fine.cu")),
}
# K4's scan is K1's (csrc/raster.cu raster_scan).
K1_OK = "const bool ok = wn > 0.f && zn >= 0.f && zn <= wn;"
K4_VARIANTS = {
    "k4_no_edge_skip": [
        ("raster.cu", "if (__any_sync(0xffffffffu, any_in)) {", "if (true) {"),
        ("raster.cu", "if (in[k]) {", "if (true) {"),
        ("raster.cu", K1_OK, K1_OK.replace("= wn", "= in[k] && wn"))],
    "k4_no_cp_async": [
        ("raster.cu", "    cp_async16(&sco[buf][cand][half], src, ok);\n"
         "    cp_async16(&sco[buf][cand][half + 4], src + 4, ok);\n"
         "    cp_async_commit();",
         "    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "    const float4* q = reinterpret_cast<const float4*>(src);\n"
         "    float4* d = reinterpret_cast<float4*>(&sco[buf][cand][half]);\n"
         "    d[0] = ok ? q[0] : z;\n"
         "    d[1] = ok ? q[1] : z;")],
    **{f"k4_min_part{n}": [
        ("common.cuh", "constexpr int OVERLAY_MIN_PART = 8;",
         f"constexpr int OVERLAY_MIN_PART = {n};")] for n in (16, 32, 64)},
    "k4_diag_empty": [
        ("raster.cu", "const int n_live = min(*a.n_live, a.n_slots);",
         "const int n_live = 0 * min(*a.n_live, a.n_slots);")],
    "k4_diag_no_scan": [
        ("raster.cu", "const int rounds = (hi - lo + STAGE - 1) / STAGE;",
         "const int rounds = 0 * (hi - lo + STAGE - 1) / STAGE;")],
}
# Variants that change the result: timed, not held.
K4_DIAGNOSTIC = ("k4_diag_empty", "k4_diag_no_scan")
FNS = {"raster_earlyz": ("raster_tiles_earlyz", "raster_tiles_earlyz_plain"),
       "raster_fine": ("raster_tiles_fine", "raster_tiles_fine_plain")}


def k4_calls(dev) -> list:
    """(label, K4 args, kw) of the overlay calls with the most live slots
    on chip_smoke.py's config-3 frames, its HUD frame and its config-5
    frames."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.pipeline import KERNELS, render_frame

    out = []
    c5 = dict(enable_shadows=True, shadow_fit_batches=(0,), enable_ibl=True)
    for label, size, caps, extra, yaws, hud in (
            ("config-3 light spheres", (cs.WIDTH, cs.HEIGHT), cs.CAPS, {},
             cs.YAWS, False),
            ("config-3 HUD", (cs.WIDTH, cs.HEIGHT), cs.CAPS, {}, cs.YAWS[:1],
             True),
            ("config-5 light spheres", (cs.C5_WIDTH, cs.C5_HEIGHT),
             cs.C5_CAPS, c5, cs.C5_YAWS, False)):
        scene, mats, overlay, proj, fp, s = cs.build_inputs(
            dev, *size, caps, **extra)
        s = dataclasses.replace(s, show_hud=hud)
        ibl = make_ibl_sh(device=dev) if extra else None
        calls: dict = {}
        for yaw in yaws:
            render_frame(scene, cs.view_block(yaw, proj, dev), fp, mats,
                         overlay, s, ibl=ibl,
                         kernels=cs.capture_kernels(KERNELS, calls),
                         hud=cs.hud_input(*size, yaw)[1] if hud else None)
        torch.cuda.synchronize()
        ks = calls["overlay"]
        args, kw, _ = ks[-1] if hud else max(ks, key=lambda c: int(c[0][7]))
        out.append((label, args, kw))
    return out


def k4_main(dev, committed) -> int:
    """K4's variants on :func:`k4_calls`."""
    import json

    import torch

    import chip_smoke as cs
    from bibim_tpu_torch import _build
    from bibim_tpu_torch.ops import fused
    from shade_variants import variant_library

    libs = {"committed": committed}
    for name, edits in K4_VARIANTS.items():
        libs[name], log = variant_library(name, edits)
        usage = {k: v for k, v in cs.ptxas_usage(log).items()
                 if "overlay_kernel" in k}
        print(f"ptxas {name}: " + json.dumps(usage), flush=True)
    _build._lib = committed
    for label, args, kw in k4_calls(dev):
        want = fused.overlay_tiles_plain(*args, **kw)
        row = {}
        for lib in ["committed", *K4_VARIANTS, "committed"]:
            _build._lib = libs[lib]
            work = args[:9] + (args[9].clone(),) + args[10:]
            got = fused.overlay_tiles(*work, **kw)
            torch.cuda.synchronize()
            row["committed_again" if lib in row else lib] = dict(
                kernel_ms=cs.graph_ms(lambda: fused.overlay_tiles(*work,
                                                                  **kw)),
                equal=bool(torch.equal(got, want)))
        _build._lib = committed
        print(f"{label} K4: " + json.dumps(row), flush=True)
        if not all(r["equal"] for n, r in row.items()
                   if n not in K4_DIAGNOSTIC):
            raise AssertionError(f"{label}: a K4 variant changed the output")
    return 0


def main() -> int:
    import argparse

    import torch

    import chip_smoke as cs
    from bibim_tpu_torch import _build
    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.pipeline import KERNELS, render_frame
    from shade_variants import variant_library

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k9k11", "k4"),
                    help="the K9 / K11 or the K4 variants alone")
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        print("raster_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    committed = _build.library()
    if only != "k9k11":
        k4_main(dev, committed)
        if only == "k4":
            return 0
    libs = {"committed": committed}
    for name, (_, edits) in VARIANTS.items():
        libs[name], log = variant_library(name, edits)
        usage = {k: v for k, v in cs.ptxas_usage(log).items()
                 if "raster_earlyz" in k or "raster_fine" in k}
        print(f"ptxas {name}: " + json.dumps(usage), flush=True)
    _build._lib = committed

    frames, fp, mats = cs.c4_frames(dev, modes=cs.C4_MODES[1:])
    for label, data, vb, s in frames:
        calls: dict = {}
        render_frame(data, vb, fp, mats, None, s,
                     kernels=cs.capture_kernels(KERNELS, calls))
        torch.cuda.synchronize()
        name = "raster_earlyz" if s.early_z else "raster_fine"
        kern = getattr(fused, FNS[name][0])
        plain = getattr(fused, FNS[name][1])
        for args, kw, out in calls[name]:
            want = plain(*args, **kw)
            if not all(torch.equal(g, w) for g, w in zip(out, want)):
                raise AssertionError(f"{label}: {name} differs from its "
                                     "plain version")
        names = ["committed"] + [n for n, (k, _) in VARIANTS.items()
                                 if k == name] + ["committed"]
        row = {}
        for lib in names:
            _build._lib = libs[lib]
            equal, ms = True, 0.0
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            for args, kw, out in calls[name]:
                kws = dict(kw, stats=stats) if s.early_z else kw
                got = kern(*args, **kws)
                torch.cuda.synchronize()
                equal &= all(torch.equal(g, w) for g, w in zip(got, out))
                ms += cs.graph_ms(lambda: kern(*args, **kw))
            res = dict(kernel_ms_per_frame=ms, launches=len(calls[name]),
                       equal=bool(equal))
            if s.early_z:
                scanned, present = stats.tolist()
                res["skipped_chunk_share"] = 1.0 - scanned / max(present, 1)
            row["committed_again" if lib in row else lib] = res
        _build._lib = committed
        print(f"config-4 {label} {name}: " + json.dumps(row), flush=True)
        if not all(r["equal"] for r in row.values()):
            raise AssertionError(f"{label}: a variant changed the output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
