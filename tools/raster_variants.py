#!/usr/bin/env python3
"""Design variants of the early-z raster K9 (csrc/raster_earlyz.cu) and the
fine-subtile raster K11 (csrc/raster_fine.cu), built from edited copies of
``csrc/`` and timed on one NVIDIA GPU beside the committed kernels.

Run from the repository root: ``python3 tools/raster_variants.py``. It
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

The split sizes (K9's cluster, K11's warps a subtile) are knobs of the
committed wrappers: ``chip_smoke.py`` prints every launch at each.
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
FNS = {"raster_earlyz": ("raster_tiles_earlyz", "raster_tiles_earlyz_plain"),
       "raster_fine": ("raster_tiles_fine", "raster_tiles_fine_plain")}


def main() -> int:
    import torch

    import chip_smoke as cs
    from bibim_tpu_torch import _build
    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.pipeline import KERNELS, render_frame
    from shade_variants import variant_library

    if not torch.cuda.is_available():
        print("raster_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    committed = _build.library()
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
