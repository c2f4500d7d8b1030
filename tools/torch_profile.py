#!/usr/bin/env python3
"""Profile of the PyTorch/CUDA port's smoke frames on one NVIDIA GPU.

Run from the repository root: ``python3 tools/torch_profile.py``. It takes
the frames of ``chip_smoke.py`` (same stand-in scenes, maps and
capacities) with ``outputs="image"``: the 1920×1080 deferred frame
(config 3) and its group-window variant (K10), the 3840×2160 shadows +
IBL frame (config 5), the config-3 frame with the in-frame HUD (the
app's stats line), the 1280×720 textured-cube frame (config 2, at the
bench's camera) and its ALBEDO G-buffer view, and the 1920×1080
64-instance frame (config 4, culled on the host and autotuned) at
chip_smoke.py's three views in its three raster modes: default (K1),
early-z (K9) and fine bins (K11). Per frame:

- 2 warm-up renders, then 6 renders timed on the host clock around
  ``render_frame`` + ``torch.cuda.synchronize()`` (no profiler);
- 4 renders under ``torch.profiler``: the wall time, the device time
  (every CUDA-side event: kernels, memcpy, memset; one stream, so they do
  not overlap) and the busy share = device time / wall time; device
  events and ``cudaLaunchKernel`` calls per frame; each port kernel's
  (``bb::*``) device time per launch, kernel only, and K1's split into
  each frame's pass 0 and its later (dense) passes; the top device ops;
- the peak device memory of those 4 renders (``max_memory_allocated``
  after a reset).

``--trace DIR`` writes each frame's Chrome trace into DIR; ``--only
LABEL ...`` profiles those frames alone (e.g. ``config3_1080p_hud``).

``--probe`` instead renders the config-5 frame at 4 yaws with generous
capacities and prints, for every raster pass and the overlay, the tiles
with pairs, the largest per-tile count, the overflow triangles and the
covered tiles: the numbers ``C5_CAPS`` in chip_smoke.py was sized from.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

# csrc kernel name → the TPU kernel it ports.
KERNEL_OF = {
    "raster_kernel": "K1", "shade_kernel": "K2", "sort_cluster": "K3",
    "sort_onesweep": "K3", "overlay_kernel": "K4",
    "gbuffer_shade_kernel": "K5", "sample_block_kernel": "K6",
    "sample_small_kernel": "K7", "mip_block_kernel": "K8",
    "raster_earlyz_kernel": "K9", "raster_gw_kernel": "K10",
    "raster_fine_kernel": "K11",
}
PROBE_CAPS = dict(
    max_candidates=2048, raster_passes=1, overflow_cap=256, span_cap=32,
    span_mid_cap=8192, pair_budget=1 << 23, live_tile_cap=None,
    raster_tile_cap=None, overlay_candidates=1024, overlay_overflow_cap=512,
    overlay_max_tiles=8192, shadow_size=1024, shadow_candidates=4096,
    shadow_passes=1, shadow_tile_cap=None)
C5_EXTRA = dict(enable_shadows=True, shadow_fit_batches=(0,),
                enable_ibl=True)


def shaderball_frames(dev, width, height, caps, extra, ibl, yaws,
                      hud=False):
    """``frame(i)`` rendering the ShaderBall stand-in at yaw i mod n
    (``hud``: with chip_smoke.py's HUD line for that yaw)."""
    from bibim_tpu_torch.pipeline import render_frame

    scene, mats, overlay, proj, fp, s = cs.build_inputs(
        dev, width, height, caps, **extra)
    s = dataclasses.replace(s, outputs="image", show_hud=hud)
    vbs = [cs.view_block(y, proj, dev) for y in yaws]
    huds = [cs.hud_input(width, height, y)[1] if hud else None
            for y in yaws]

    def frame(i):
        render_frame(scene, vbs[i % len(vbs)], fp, mats, overlay, s, ibl=ibl,
                     hud=huds[i % len(vbs)])

    return frame


def cube_frames(dev, **extra):
    """``frame(i)`` rendering config 2 at the bench's camera."""
    from bibim_tpu_torch.pipeline import render_frame

    scene, mats, proj, fp, s = cs.cube_inputs(dev)
    s = dataclasses.replace(s, outputs="image", **extra)
    vb = cs.cube_view(cs.C2_CAMERA_Z[0], proj, dev)

    def frame(i):
        render_frame(scene, vb, fp, mats, None, s)

    return frame


def group_window_frames(dev):
    """``frame(i)`` rendering config 3 with group_pair_cap from the port's
    probe of the first yaw (as chip_smoke.py sizes it)."""
    from bibim_tpu_torch.pipeline import render_frame
    from bibim_tpu_torch.pipeline.autotune import (
        derive_settings,
        probe_frame_caps,
    )

    scene, mats, overlay, proj, fp, s = cs.build_inputs(dev)
    s = dataclasses.replace(s, outputs="image")
    vbs = [cs.view_block(y, proj, dev) for y in cs.YAWS]
    probe = probe_frame_caps(scene, vbs[0], s)
    s = dataclasses.replace(s, group_pair_cap=derive_settings(
        dataclasses.replace(s, group_pair_cap=s.max_candidates),
        probe).group_pair_cap)

    def frame(i):
        render_frame(scene, vbs[i % len(vbs)], fp, mats, overlay, s)

    return frame


def instanced_scene(dev):
    """Config 4's scene, maps, projection (host and device) and frame
    parameters, as chip_smoke.py builds them."""
    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import FrameParams
    from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    scene = ShaderBallScene(num_instances=cs.C4_INSTANCES, device=dev,
                            ball_mesh=generate_uv_sphere_mesh(100.0, 100,
                                                              51))
    proj_host = m3.perspective(60.0, cs.WIDTH / cs.HEIGHT, 0.1,
                               1000.0).numpy()
    fp = FrameParams(torch.tensor(1, dtype=torch.int32, device=dev),
                     torch.tensor(1.0, device=dev))
    return (scene, cs.standin_materials(dev), proj_host,
            torch.as_tensor(proj_host, device=dev), fp)


def instanced_settings(dev, c4, view, **extra):
    """(frame data, view block, settings) of config 4 at ``view``: culled
    on the host, autotuned for ``extra`` (the dense-pass slot count picked
    by device time, chip_smoke.py pick_dense_cap)."""
    from bibim_tpu_torch.pipeline import RenderSettings
    from bibim_tpu_torch.pipeline.autotune import (
        autotune_settings,
        dense_cap_candidates,
    )

    scene, mats, proj_host, proj, fp = c4
    vb, view_host = cs.c4_view(view, proj, dev)
    data = scene.culled_scene_data(view_host, proj_host)
    base = RenderSettings(width=cs.WIDTH, height=cs.HEIGHT, outputs="image",
                          show_gizmo=False, show_lights=False, **extra)
    s, probe = autotune_settings(data, vb, base, margin=cs.C4_MARGIN)
    cands = dense_cap_candidates(s, probe, margin=cs.C4_MARGIN)
    if len(cands) > 1:
        s, _ = cs.pick_dense_cap(cands, data, vb, fp, mats)
    print(json.dumps({"config4_settings": {"view": view[0], **{
        k: getattr(s, k) for k in ("max_candidates", "raster_passes",
                                   "merged_coverage", "dense_tile_cap",
                                   "early_z", "fine_bins")}}}))
    return data, vb, s


def instanced_frames(c4, data, vb, s):
    """``frame(i)`` rendering one config-4 view with settings ``s``."""
    from bibim_tpu_torch.pipeline import render_frame

    _, mats, _, _, fp = c4

    def frame(i):
        render_frame(data, vb, fp, mats, None, s)

    return frame


def profile(label, frame, trace_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for i in range(2):
        frame(i)
    ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    n = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            frame(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()

    ka = prof.key_averages()
    dev_ev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    kern = defaultdict(lambda: [0.0, 0])
    for e in dev_ev:
        m = re.search(r"bb::(\w+)", e.key)
        if m and m.group(1) in KERNEL_OF:
            k = kern[KERNEL_OF[m.group(1)]]
            k[0] += e.self_device_time_total / 1e3
            k[1] += e.count
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:12]
    # K1 launches in time order: a frame's first is its pass 0, the rest
    # its dense passes (their cluster split differs).
    k1 = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "raster_kernel" in e.name),
                key=lambda e: e.time_range.start)
    k1_split = {}
    if k1 and len(k1) % n == 0 and len(k1) > n:
        per = len(k1) // n
        k1_ms = [e.time_range.elapsed_us() / 1e3 for e in k1]
        k1_split = {"k1_pass0_ms": statistics.mean(k1_ms[::per]),
                    "k1_later_passes_ms": statistics.mean(
                        m for i, m in enumerate(k1_ms) if i % per)}
    print(json.dumps({
        "frame": label,
        "host_ms_no_profiler": ms,
        "host_ms_median": statistics.median(ms),
        "profiled_frames": n,
        "profiled_wall_ms_per_frame": wall / n,
        "device_ms_per_frame": dev_ms / n,
        "busy_share": dev_ms / wall,
        "device_events_per_frame": sum(e.count for e in dev_ev) / n,
        "cudaLaunchKernel_per_frame": launches / n,
        "peak_device_memory_bytes": peak,
        "port_kernels": {k: {"ms_per_frame": v[0] / n,
                             "launches_per_frame": v[1] / n,
                             "ms_per_launch": v[0] / v[1]}
                         for k, v in sorted(kern.items())},
        **k1_split,
        "top_device_ops": [{"name": e.key[:90], "count": e.count,
                            "ms_per_frame":
                            e.self_device_time_total / 1e3 / n}
                           for e in top],
    }))
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{label}.json"))


def probe(dev):
    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.pipeline import KERNELS, render_frame

    scene, mats, overlay, proj, fp, s = cs.build_inputs(
        dev, cs.C5_WIDTH, cs.C5_HEIGHT, PROBE_CAPS, **C5_EXTRA)
    ibl = make_ibl_sh(device=dev)
    shadow = cs.shadow_fields()
    for yaw in (0.0, -25.0, -50.0, -75.0):
        stats = []

        def raster(*a, **k):
            zk, f = KERNELS.raster(*a, **k)
            counts, nt = a[6], int(a[4].shape[0])
            live = (counts > 0) | fused._big_cover_mask(
                fused._overflow_rows(a[0], a[1]), a[1], nt, a[8], a[9],
                a[10])
            idf = f[a[11].index("idf")]
            stats.append(dict(
                kind="shadow" if tuple(a[11]) == shadow else "main",
                slots=nt, live_tiles=int(live.sum()),
                tiles_with_pairs=int((counts > 0).sum()),
                max_count=int(counts.max()), overflow=int(a[2].item()),
                pairs=int(a[3].shape[0]),
                covered_tiles=int((idf >= 0.5).any(1).sum())))
            return zk, f

        def overlay_k(*a, **k):
            stats.append(dict(kind="overlay", live_tiles=int(a[7].item()),
                              max_count=int(a[6].max()),
                              overflow=int(a[2].item())))
            return KERNELS.overlay(*a, **k)

        out = render_frame(scene, cs.view_block(yaw, proj, dev), fp, mats,
                           overlay, s, ibl=ibl,
                           kernels=KERNELS._replace(raster=raster,
                                                    overlay=overlay_k))
        torch.cuda.synchronize()
        print(json.dumps({"yaw": yaw, "bin_diag": [
            int(x) for x in out["bin_diag"]], "passes": stats}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true",
                    help="capacity probe of the config-5 frame")
    ap.add_argument("--only", nargs="+", metavar="FRAME",
                    help="profile only these frames (their labels)")
    ap.add_argument("--trace", metavar="DIR",
                    help="write each frame's Chrome trace into DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    from bibim_tpu_torch.ops.ibl import make_ibl_sh

    print(cs.nvidia_smi_line())
    dev = torch.device("cuda", 0)
    if args.probe:
        probe(dev)
        return 0
    from bibim_tpu_torch.pipeline import GBufferViz

    frames = [
        ("config3_1080p", lambda: shaderball_frames(
            dev, cs.WIDTH, cs.HEIGHT, cs.CAPS, {}, None, cs.YAWS)),
        ("config3_1080p_group_window", lambda: group_window_frames(dev)),
        ("config3_1080p_hud", lambda: shaderball_frames(
            dev, cs.WIDTH, cs.HEIGHT, cs.CAPS, {}, None, cs.YAWS,
            hud=True)),
        ("config5_4k_shadows_ibl", lambda: shaderball_frames(
            dev, cs.C5_WIDTH, cs.C5_HEIGHT, cs.C5_CAPS, C5_EXTRA,
            make_ibl_sh(device=dev), cs.C5_YAWS)),
        ("config2_720p_cubes", lambda: cube_frames(dev)),
        ("config2_720p_albedo_view",
         lambda: cube_frames(dev, gbuffer_viz=GBufferViz.ALBEDO)),
    ]
    c4 = []
    for view in cs.C4_VIEWS:
        for label, extra in cs.C4_MODES:
            tag = view[0].replace(" ", "_")
            frames.append((f"config4_x64_1080p_{tag}_{label}",
                           lambda view=view, extra=extra: instanced_frames(
                               c4[0], *instanced_settings(
                                   dev, c4[0], view, **extra))))
    for label, make in frames:
        if args.only and label not in args.only:
            continue
        if label.startswith("config4") and not c4:
            c4.append(instanced_scene(dev))
        profile(label, make(), args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
