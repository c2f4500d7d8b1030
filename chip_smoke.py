#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bibim_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the four CUDA kernels from ``bibim_tpu_torch/csrc`` (into
   ``build/``) and prints the build time;
2. builds a 1920×1080 deferred PBR frame from repository-only inputs: the
   ShaderBall scene's structure (100× ground plane at y=-10, the three
   ShaderBall lights, the default camera) with a ~10k-triangle UV sphere at
   the ball's instance transform standing in for ShaderBall.fbx, and seeded
   random materials bound like the headline frame — 2048² metallic /
   roughness / ao as one block table, 16² albedo / normal / height as one
   quad table; light spheres on, gizmo off (gizmo.obj is not in the
   repository);
3. checks each kernel (K1 raster, K2 sampled shade, K3 pair sort, K4
   overlay) against its plain PyTorch version on the inputs the frame
   itself produces, and times both (median of CUDA-event timings);
4. renders 4 frames at 4 camera yaws through ``render_frame`` with launch
   counters reset just before, checks zero capacity drops, coverage, that
   the image is not background, and each frame against the all-plain
   render of the same frame at the golden-image bound;
5. prints the GPU's ``nvidia-smi`` name/power-limit line, one JSON line of
   kernel results and, last, ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is non-zero. Without a GPU, or without
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
WIDTH, HEIGHT = 1920, 1080
# Yaw 0 faces the ball; at -75 the ball is out of view and the spot-lit
# point light's sphere (4, 2, 0) is in it.
YAWS = (0.0, -25.0, -50.0, -75.0)
# Explicit capacities for this frame (validated: any overflow is reported
# in BinDiag and fails check_bin_diag).
CAPS = dict(
    max_candidates=512, raster_passes=1, overflow_cap=64, span_cap=16,
    span_mid_cap=4096, pair_budget=262144, live_tile_cap=1536,
    raster_tile_cap=1536, overlay_candidates=384, overlay_overflow_cap=512,
    overlay_max_tiles=512,
)
KERNEL_INFO = {
    "raster": ("K1 raster", "bibim_tpu_torch/csrc/raster.cu",
               "bibim_tpu/ops/fused.py:670"),
    "shade": ("K2 sampled shade", "bibim_tpu_torch/csrc/shade.cu",
              "bibim_tpu/ops/shading_pallas.py:294"),
    "sort": ("K3 pair sort", "bibim_tpu_torch/csrc/sort.cu",
             "bibim_tpu/ops/sort_pallas.py:43"),
    "overlay": ("K4 overlay composite", "bibim_tpu_torch/csrc/overlay.cu",
                "bibim_tpu/ops/fused.py:1882"),
}


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` by CUDA events (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def build_inputs(dev):
    import numpy as np
    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.pipeline import (
        BLOCK_TABLE_THRESHOLD,
        FrameParams,
        RenderSettings,
        make_overlay_resources,
    )
    from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
    from bibim_tpu_torch.scene.scene import SceneData, batch_from_mesh
    from bibim_tpu_torch.scene.shaderball import (
        ground_plane_batch,
        shaderball_instance_matrices,
        shaderball_lights,
    )

    # Stand-in ball: radius 100 in model units (the FBX's centimetres),
    # 2·100·50 = 10,000 triangles, under the ball's instance transform
    # translate(0,-1,2)·rotY(-90)·rotX(-90)·scale(0.01).
    ball_mesh = generate_uv_sphere_mesh(100.0, 100, 51)
    model, _ = shaderball_instance_matrices(1, -90.0)
    ball = batch_from_mesh(ball_mesh, model, device=dev)
    scene = SceneData(batches=(ball, ground_plane_batch(dev)),
                      lights=shaderball_lights(dev))

    rng = np.random.default_rng(SEED)

    def tex(n):
        return rng.integers(0, 256, (n, n, 1), dtype=np.uint8)

    maps = {s: tex(2048) for s in ("metallic", "roughness", "ao")}
    maps.update({s: tex(16) for s in ("alb_r", "alb_g", "alb_b", "nrm_x",
                                     "nrm_y", "nrm_z", "height")})
    mats = tq.build_quad_tables(maps, block_threshold=BLOCK_TABLE_THRESHOLD,
                                device=dev)
    kinds = [type(t).__name__ for t in mats]
    if sorted(kinds) != ["BlockTable", "QuadTable"]:
        raise AssertionError(f"unexpected material binding {kinds}")
    overlay = make_overlay_resources(dev, with_gizmo=False)
    proj = m3.perspective(60.0, WIDTH / HEIGHT, 0.1, 1000.0, device=dev)
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(1, dtype=torch.int32, device=dev),
        exposure=torch.tensor(1.0, dtype=torch.float32, device=dev))
    settings = RenderSettings(width=WIDTH, height=HEIGHT,
                              outputs="image+diag", show_gizmo=False, **CAPS)
    return scene, mats, overlay, proj, fp, settings


def view_block(yaw: float, proj, dev):
    import torch

    from bibim_tpu_torch.pipeline import ViewBlock
    from bibim_tpu_torch.scene.camera import FreeLookCamera

    cam = FreeLookCamera(yaw=yaw)
    return ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=dev),
        proj=proj,
        view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(0, dtype=torch.int32, device=dev))


def capture_kernels(kernels, calls: dict):
    """Kernels that record every call's arguments and result."""
    from bibim_tpu_torch.pipeline import Kernels

    def wrap(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            calls.setdefault(name, []).append((args, kw, out))
            return out
        return run

    return Kernels(*(wrap(n, f) for n, f in zip(Kernels._fields, kernels)))


def assert_golden_bound(got, want, what: str) -> None:
    d = (got.to(int) - want.to(int)).abs()
    frac = float((d > 0).any(dim=-1).float().mean())
    if int(d.max()) > 2 or frac > 1e-3:
        raise AssertionError(f"{what}: max LSB diff {int(d.max())}, "
                             f"{frac:.4%} pixels differ")


def check_kernels(calls: dict) -> dict:
    """Each kernel vs its plain version on the frame's own inputs."""
    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain
    from bibim_tpu_torch.ops.sort import sort_keys, sort_keys_plain

    res = {}

    # K3: the largest sort of the frame (the main pass's pair keys).
    keys = max((c[0][0] for c in calls["sort"]), key=lambda k: k.numel())
    got, want = sort_keys(keys), sort_keys_plain(keys)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K3 sort differs from torch.sort")
    res["sort"] = dict(max_abs_err=0.0, shape=list(keys.shape),
                       ms=cuda_ms(lambda: sort_keys(keys)),
                       plain_ms=cuda_ms(lambda: sort_keys_plain(keys)))

    # K1: the main raster pass of the first frame.
    args, kw, _ = calls["raster"][0]
    zk, f = fused.raster_tiles(*args, **kw)
    zk_p, f_p = fused.raster_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    idf = args[11].index("idf")
    if not torch.equal(zk, zk_p) or not torch.equal(f[idf], f_p[idf]):
        raise AssertionError("K1: zkey / tri_id differ from the plain raster")
    err = float((f - f_p).abs().max())
    if err > 1e-3:  # attribute planes (tests/test_fused.py bound)
        raise AssertionError(f"K1 attribute planes differ by {err}")
    res["raster"] = dict(max_abs_err=err, slots=int(args[4].shape[0]),
                         ms=cuda_ms(lambda: fused.raster_tiles(*args, **kw)),
                         plain_ms=cuda_ms(
                             lambda: fused.raster_tiles_plain(*args, **kw)))

    # K2: the first frame's sampled shade, with its normal-map toggle
    # (off, as on the headline frame) and with the normal map on.
    args, kw, _ = calls["shade"][0]
    errs = []
    for nm in (args[9], torch.ones_like(args[9])):
        a2 = args[:9] + (nm,) + args[10:]
        got = shade_sampled(*a2, **kw)
        want = shade_sampled_plain(*a2, **kw)
        torch.cuda.synchronize()
        for c in range(3):
            diff = (got[c] - want[c]).abs()
            frac = float((diff > 5e-5).float().mean())
            mx = float(diff.max())
            if frac >= 1e-3 or mx >= 2e-3:  # test_shading_pallas bound
                raise AssertionError(f"K2 channel {c}: {frac:.4%} > 5e-5, "
                                     f"max {mx}")
            errs.append(mx)
    res["shade"] = dict(max_abs_err=max(errs), pixels=int(args[1].numel()),
                        ms=cuda_ms(lambda: shade_sampled(*args, **kw)),
                        plain_ms=cuda_ms(
                            lambda: shade_sampled_plain(*args, **kw)))

    # K4: the light-sphere composite with the most live tiles.
    args, kw, _ = max(calls["overlay"], key=lambda c: int(c[0][7]))
    got = fused.overlay_tiles(*args, **kw)
    want = fused.overlay_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 composite differs from the plain version")
    changed = int((got != args[9]).any(dim=0).sum())
    if changed == 0:
        raise AssertionError("K4 composited no pixel")
    res["overlay"] = dict(max_abs_err=0.0, live_slots=int(args[7]),
                          pixels_changed=changed,
                          ms=cuda_ms(lambda: fused.overlay_tiles(*args,
                                                                 **kw)),
                          plain_ms=cuda_ms(
                              lambda: fused.overlay_tiles_plain(*args,
                                                                **kw)))
    return res


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        from bibim_tpu_torch import _build
        from bibim_tpu_torch.ops import fused
        from bibim_tpu_torch.ops.shading import shade_sampled
        from bibim_tpu_torch.ops.sort import sort_keys
        from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame
        from bibim_tpu_torch.utils.validation import check_bin_diag
    except ImportError as e:
        print(f"chip_smoke: the bibim_tpu_torch package is not importable "
              f"({e}); run from the repository root", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} ({smi})")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds or 0.0:.1f} s)")

    scene, mats, overlay, proj, fp, settings = build_inputs(dev)
    t = sum(int(b.positions.shape[0]) // 3 * int(b.model.shape[0])
            for b in scene.batches)
    print(f"smoke frame: {WIDTH}x{HEIGHT}, {t} triangles, lights "
          f"{scene.lights.num_lights}, materials "
          f"{[(type(m).__name__, m.height, m.width) for m in mats]}; gizmo "
          "off: gizmo.obj is not in the repository")
    print("capacities: " + json.dumps(CAPS))

    # Kernel phases on the inputs the smoke frames produce.
    calls: dict = {}
    for yaw in YAWS:
        render_frame(scene, view_block(yaw, proj, dev), fp, mats, overlay,
                     settings, kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres = check_kernels(calls)
    for k, v in kres.items():
        print(f"kernel {k}: " + json.dumps(v))
    del calls

    # Main path: counters to 0, four frames through render_frame.
    vbs = [view_block(y, proj, dev) for y in YAWS]
    counters = (fused.raster_tiles, shade_sampled, sort_keys,
                fused.overlay_tiles)
    for fn in counters:
        fn.launches = 0
    cover: list = []

    def raster_cover(*args, **kw):
        zk, f = KERNELS.raster(*args, **kw)
        cover.append(f[args[11].index("idf")] >= 0.5)
        return zk, f

    counted = KERNELS._replace(raster=raster_cover)
    outs, frame_ms = [], []
    for vb in vbs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_frame(scene, vb, fp, mats, overlay, settings,
                           kernels=counted)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((out, cover[-1]))
    launches = {"raster": fused.raster_tiles.launches,
                "shade": shade_sampled.launches,
                "sort": sort_keys.launches,
                "overlay": fused.overlay_tiles.launches}
    print("main-path launches: " + json.dumps(launches))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the frame")

    for i, ((out, cov), vb) in enumerate(zip(outs, vbs)):
        img = out["image"]
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"frame {i}: image {tuple(img.shape)} "
                                 f"{img.dtype}")
        check_bin_diag(out["bin_diag"], where=f"frame {i}")
        covered = float(cov.float().mean())
        if not covered > 0.0:
            raise AssertionError(f"frame {i}: no pixel covered")
        non_bg = float((img != 0).any(dim=-1).float().mean())
        if not non_bg > 0.0:
            raise AssertionError(f"frame {i}: image is all background")
        ref = render_frame(scene, vb, fp, mats, overlay, settings,
                           kernels=PLAIN)["image"]
        assert_golden_bound(img, ref, f"frame {i} vs the plain render")
        same = float((img == ref).all(dim=-1).float().mean())
        print(f"frame {i}: yaw {YAWS[i]}, {frame_ms[i]:.2f} ms, covered "
              f"{covered:.4f} of main-pass tile pixels, non-background "
              f"{non_bg:.4f}, identical to plain {same:.6f}")
    print(f"frame time median: {statistics.median(frame_ms):.2f} ms "
          f"(host clock around render_frame + synchronize, {name}, {smi})")

    kernels = []
    for k in ("raster", "shade", "sort", "overlay"):
        label, src, repl = KERNEL_INFO[k]
        r = kres[k]
        kernels.append({"name": label, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
