#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bibim_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the eight CUDA kernels from ``bibim_tpu_torch/csrc`` (into
   ``build/``, one nvcc per source in parallel) and prints the build time;
2. builds the frames from repository-only inputs: the ShaderBall scene's
   structure (100× ground plane at y=-10, the three ShaderBall lights, the
   default camera) with a ~10k-triangle UV sphere at the ball's instance
   transform standing in for ShaderBall.fbx, and seeded random materials
   bound like the headline frame — 2048² metallic / roughness / ao as one
   block table, 16² albedo / normal / height as one quad table; light
   spheres on, gizmo off (gizmo.obj is not in the repository);
3. the 1920×1080 deferred PBR path (BASELINE config 3): checks K1 raster,
   K2 sampled shade (with and without a shadow visibility plane), K3 pair
   sort and K4 overlay against their plain PyTorch versions on the inputs
   the frame itself produces and times both (median of CUDA-event
   timings); renders 4 frames at 4 camera yaws through ``render_frame``
   with launch counters reset just before;
4. the 3840×2160 shadows + IBL path (BASELINE config 5: shadow map of the
   ball at 1024², analytic IBL from the procedural sky): checks K1 (the
   4K main pass and the 1024² shadow pass), K3 (every sort), K4, K5
   G-buffer shade, K6 block-table and K7 small-table samplers against
   their plain versions on that path's inputs and times both; renders 3
   frames with the counters reset just before, the shadow pass's K1
   launches counted apart;
5. the 1280×720 textured-cube path (BASELINE config 2: two cubes,
   trilinear mip-block albedos from seeded 1024² / 2048² stand-ins, two
   materials routed by batch): renders the bench frame at three camera
   positions and the ALBEDO and MRHA G-buffer views of the first; checks
   K1, K3, K2 with the mip-block and routed small groups, K8 mip-block and
   K7 (routed rows) against their plain versions on that path's inputs
   (K2 and K8 bit-equal) and times both; renders the five frames again
   with the counters reset just before, and prints per view a histogram of
   the selected mip level and the share of pixels blending two levels;
6. checks, on every frame, zero capacity drops (shadow pass included),
   coverage, that the image is not background, and the frame against the
   all-plain render of the same frame at the golden-image bound;
7. prints the GPU's ``nvidia-smi`` name/power-limit line, one JSON line of
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
# BASELINE config 5 (bench.py bench_stretch_4k): 4K, shadows fit to the
# ball, analytic IBL, light spheres.
C5_WIDTH, C5_HEIGHT = 3840, 2160
# -75: the ball is out of view and a light sphere in it, so K4
# composites pixels on this path too.
C5_YAWS = (0.0, -25.0, -75.0)
C5_CAPS = dict(
    max_candidates=128, raster_passes=1, overflow_cap=64, span_cap=32,
    span_mid_cap=8192, pair_budget=262144, live_tile_cap=4096,
    raster_tile_cap=4096, overlay_candidates=384, overlay_overflow_cap=512,
    overlay_max_tiles=1024, shadow_size=1024, shadow_candidates=256,
    shadow_passes=1, shadow_tile_cap=1024,
)
# BASELINE config 2 (bench.py bench_cube): two textured cubes, trilinear
# mip-block albedos, materials by batch, 1280x720, no light spheres or
# gizmo. Seeded stand-ins for uv_debug.png / texture.jpg (not in the
# repository), powers of two like the reference's assets.
C2_WIDTH, C2_HEIGHT = 1280, 720
C2_ALBEDOS = (1024, 2048)
# Camera z: the bench's view, then pulled back along the view axis until
# levels >= 3 are selected (the cubes sit at z = 3).
C2_CAMERA_Z = (0.0, -6.0, -24.0)
C2_VIEWS = ("ALBEDO", "MRHA")
# Explicit capacities: at z = 0 the main pass has 264 live and 248
# covered tiles of 900, at most 4 candidates per tile (4 overflow
# triangles); fewer further back.
C2_CAPS = dict(
    max_candidates=64, raster_passes=1, overflow_cap=64, span_cap=16,
    span_mid_cap=1024, pair_budget=262144, live_tile_cap=384,
    raster_tile_cap=384,
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
    "shade_gbuffer": ("K5 G-buffer shade",
                      "bibim_tpu_torch/csrc/gbuffer_shade.cu",
                      "bibim_tpu/ops/shading_pallas.py:160"),
    "sample_block": ("K6 block-table sample",
                     "bibim_tpu_torch/csrc/sample.cu",
                     "bibim_tpu/ops/texture_quad.py:312"),
    "sample_small": ("K7 small-table sample",
                     "bibim_tpu_torch/csrc/sample.cu",
                     "bibim_tpu/ops/texture_quad.py:754"),
    "sample_mip_block": ("K8 mip-block sample",
                         "bibim_tpu_torch/csrc/mip_sample.cu",
                         "bibim_tpu/ops/texture_quad.py:1743"),
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


def build_inputs(dev, width=WIDTH, height=HEIGHT, caps=CAPS, **extra):
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
    proj = m3.perspective(60.0, width / height, 0.1, 1000.0, device=dev)
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(1, dtype=torch.int32, device=dev),
        exposure=torch.tensor(1.0, dtype=torch.float32, device=dev))
    settings = RenderSettings(width=width, height=height,
                              outputs="image+diag", show_gizmo=False,
                              **caps, **extra)
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


def shadow_fields() -> tuple:
    """The planes the shadow pass's K1 writes (it drops ``_SHADOW_DROP``);
    they tell its raster calls from the main pass's."""
    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.pipeline.framegraph import _SHADOW_DROP

    return tuple(f for f in fused._OUT_FIELDS if f not in _SHADOW_DROP)


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


def assert_shade_close(got, want, what: str, rel: bool = False) -> float:
    """tests/test_shading_pallas.py _assert_close (``rel``: relative to
    1 + |want|, its _assert_close_rel); returns the max abs error."""
    errs = []
    for c in range(3):
        diff = (got[c] - want[c]).abs()
        errs.append(float(diff.max()))
        if rel:
            diff = diff / (1.0 + want[c].abs())
        frac = float((diff > 5e-5).float().mean())
        mx = float(diff.max())
        if frac >= 1e-3 or mx >= 2e-3:
            raise AssertionError(f"{what} channel {c}: {frac:.4%} > 5e-5, "
                                 f"max {mx}")
    return max(errs)


def assert_golden_bound(got, want, what: str) -> None:
    d = (got.to(int) - want.to(int)).abs()
    frac = float((d > 0).any(dim=-1).float().mean())
    if int(d.max()) > 2 or frac > 1e-3:
        raise AssertionError(f"{what}: max LSB diff {int(d.max())}, "
                             f"{frac:.4%} pixels differ")


def check_raster(call) -> dict:
    """K1 on one captured raster call: zkey and tri_id bit-equal to the
    plain raster, attribute planes within tests/test_fused.py's bound."""
    import torch

    from bibim_tpu_torch.ops import fused

    args, kw, _ = call
    zk, f = fused.raster_tiles(*args, **kw)
    zk_p, f_p = fused.raster_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    idf = args[11].index("idf")
    if not torch.equal(zk, zk_p) or not torch.equal(f[idf], f_p[idf]):
        raise AssertionError("K1: zkey / tri_id differ from the plain raster")
    err = float((f - f_p).abs().max())
    if err > 1e-3:
        raise AssertionError(f"K1 attribute planes differ by {err}")
    return dict(max_abs_err=err, slots=int(args[4].shape[0]),
                planes=len(args[11]),
                ms=cuda_ms(lambda: fused.raster_tiles(*args, **kw)),
                plain_ms=cuda_ms(lambda: fused.raster_tiles_plain(*args,
                                                                  **kw)))


def check_sorts(calls: list) -> dict:
    """K3 on every captured sort (bit-equal to torch.sort); the largest
    is timed."""
    import torch

    from bibim_tpu_torch.ops.sort import sort_keys, sort_keys_plain

    for args, _, _ in calls:
        keys = args[0]
        got, want = sort_keys(keys), sort_keys_plain(keys)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 sort of {tuple(keys.shape)} "
                                 f"{keys.dtype} differs from torch.sort")
    keys = max((c[0][0] for c in calls), key=lambda k: k.numel())
    return dict(max_abs_err=0.0, sorts=len(calls), shape=list(keys.shape),
                ms=cuda_ms(lambda: sort_keys(keys)),
                plain_ms=cuda_ms(lambda: sort_keys_plain(keys)))


def check_overlay(calls: list) -> dict:
    """K4 on the light-sphere composite with the most live tiles
    (bit-equal to its plain version)."""
    import torch

    from bibim_tpu_torch.ops import fused

    args, kw, _ = max(calls, key=lambda c: int(c[0][7]))
    got = fused.overlay_tiles(*args, **kw)
    want = fused.overlay_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 composite differs from the plain version")
    changed = int((got != args[9]).any(dim=0).sum())
    if changed == 0:
        raise AssertionError("K4 composited no pixel")
    return dict(max_abs_err=0.0, live_slots=int(args[7]),
                pixels_changed=changed,
                ms=cuda_ms(lambda: fused.overlay_tiles(*args, **kw)),
                plain_ms=cuda_ms(lambda: fused.overlay_tiles_plain(*args,
                                                                   **kw)))


def check_kernels(calls: dict) -> dict:
    """K1-K4 vs their plain versions on the 1080p frames' own inputs."""
    import torch

    from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain

    res = {"sort": check_sorts(calls["sort"]),
           # K1: the main raster pass of the first frame.
           "raster": check_raster(calls["raster"][0])}

    # K2: the first frame's sampled shade, with its normal-map toggle
    # (off, as on the headline frame) and with the normal map on; then
    # with a seeded [0, 1] shadow visibility plane on light 0 (the
    # shadows-without-IBL path).
    args, kw, _ = calls["shade"][0]
    errs = []
    for nm in (args[9], torch.ones_like(args[9])):
        a2 = args[:9] + (nm,) + args[10:]
        got = shade_sampled(*a2, **kw)
        want = shade_sampled_plain(*a2, **kw)
        torch.cuda.synchronize()
        errs.append(assert_shade_close(got, want, "K2"))
    gen = torch.Generator(device=args[1].device).manual_seed(SEED)
    vis = torch.rand(args[1].shape, generator=gen, device=args[1].device)
    kw_vis = dict(kw, vis_plane=vis, vis_light=0)
    got = shade_sampled(*args, **kw_vis)
    want = shade_sampled_plain(*args, **kw_vis)
    torch.cuda.synchronize()
    vis_err = assert_shade_close(got, want, "K2 with visibility")
    if torch.equal(got[0], shade_sampled(*args, **kw)[0]):
        raise AssertionError("K2: the visibility plane changed nothing")
    res["shade"] = dict(max_abs_err=max(errs + [vis_err]),
                        vis_max_abs_err=vis_err,
                        pixels=int(args[1].numel()),
                        ms=cuda_ms(lambda: shade_sampled(*args, **kw)),
                        plain_ms=cuda_ms(
                            lambda: shade_sampled_plain(*args, **kw)),
                        vis_ms=cuda_ms(lambda: shade_sampled(*args,
                                                             **kw_vis)),
                        vis_plain_ms=cuda_ms(
                            lambda: shade_sampled_plain(*args, **kw_vis)))

    res["overlay"] = check_overlay(calls["overlay"])
    return res


def check_kernels_c5(calls: dict) -> dict:
    """K1 (main and shadow pass), K3, K4, K5, K6 and K7 vs their plain
    versions on the config-5 frames' own inputs."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.shading import shade_tonemap, shade_tonemap_plain

    shadow = shadow_fields()
    res = {
        "raster": check_raster(next(
            c for c in calls["raster"] if tuple(c[0][11]) != shadow)),
        "raster_shadow_pass": check_raster(next(
            c for c in calls["raster"] if tuple(c[0][11]) == shadow)),
        "sort": check_sorts(calls["sort"]),
        "overlay": check_overlay(calls["overlay"]),
    }
    # K5 as the frame calls it (IBL ambient, shadow visibility, no
    # quantize, no tonemap), and with fp16 + tone map on.
    args, kw, _ = calls["shade_gbuffer"][0]
    got = shade_tonemap(*args, **kw)
    want = shade_tonemap_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = [assert_shade_close(got, want, "K5", rel=True)]
    kw_tm = dict(kw, quantize=True, tonemap=True)
    got = shade_tonemap(*args, **kw_tm)
    want = shade_tonemap_plain(*args, **kw_tm)
    torch.cuda.synchronize()
    errs.append(assert_shade_close(got, want, "K5 quantize+tonemap"))
    res["shade_gbuffer"] = dict(
        max_abs_err=max(errs), pixels=int(args[3].numel()),
        vis=kw.get("vis_plane") is not None,
        ambient=kw.get("ambient") is not None,
        ms=cuda_ms(lambda: shade_tonemap(*args, **kw)),
        plain_ms=cuda_ms(lambda: shade_tonemap_plain(*args, **kw)))

    # K6 and K7: bit-equal to their plain versions.
    res["sample_block"] = check_sampler(
        calls["sample_block"][0], tq.sample_table_block_kernel,
        tq.sample_table_block, "sample_block")
    res["sample_small"] = check_sampler(
        calls["sample_small"][0], tq.sample_rows_small,
        tq.sample_rows_small_plain, "sample_small")
    return res


def check_sampler(call, kern, plain, name: str) -> dict:
    """A sampler kernel (K6, K7, K8) on one captured call: every slot
    plane bit-equal to its plain version; both timed."""
    import torch

    args, kw, _ = call
    got = kern(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    for slot in want:
        if not torch.equal(got[slot], want[slot]):
            err = float((got[slot] - want[slot]).abs().max())
            raise AssertionError(f"{name} slot {slot} differs from the "
                                 f"plain version by {err}")
    plane = next(iter(want.values()))
    table = args[0] if isinstance(args[0], torch.Tensor) else args[0][0]
    return dict(max_abs_err=0.0, pixels=int(plane.numel()),
                table=list(table.shape), slots=len(want),
                ms=cuda_ms(lambda: kern(*args, **kw)),
                plain_ms=cuda_ms(lambda: plain(*args, **kw)))


def check_frame(i: int, out, cov, ref, shape, what: str) -> str:
    """Image type, zero drops, coverage, not background, golden bound
    against the all-plain render; returns a summary."""
    import torch

    from bibim_tpu_torch.utils.validation import check_bin_diag

    img = out["image"]
    if tuple(img.shape) != shape or img.dtype != torch.uint8:
        raise AssertionError(f"{what} frame {i}: image {tuple(img.shape)} "
                             f"{img.dtype}")
    check_bin_diag(out["bin_diag"], where=f"{what} frame {i}")
    covered = float(cov.float().mean())
    if not covered > 0.0:
        raise AssertionError(f"{what} frame {i}: no pixel covered")
    non_bg = float((img != 0).any(dim=-1).float().mean())
    if not non_bg > 0.0:
        raise AssertionError(f"{what} frame {i}: image is all background")
    assert_golden_bound(img, ref, f"{what} frame {i} vs the plain render")
    same = float((img == ref).all(dim=-1).float().mean())
    return (f"covered {covered:.4f} of main-pass tile pixels, "
            f"non-background {non_bg:.4f}, identical to plain {same:.6f}")


def run_config5(dev, smi: str, name: str):
    """The shadows + IBL path: kernel phases, then the counted frames."""
    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.ops.shading import shade_sampled, shade_tonemap
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame

    scene, mats, overlay, proj, fp, settings = build_inputs(
        dev, C5_WIDTH, C5_HEIGHT, C5_CAPS, enable_shadows=True,
        shadow_fit_batches=(0,), enable_ibl=True)
    ibl = make_ibl_sh(device=dev)
    print(f"config-5 frame: {C5_WIDTH}x{C5_HEIGHT}, shadows (map "
          f"{settings.shadow_size}², fit to batch 0), analytic IBL "
          "(procedural sky), light spheres on, gizmo off")
    print("config-5 capacities: " + json.dumps(C5_CAPS))

    calls: dict = {}
    for yaw in C5_YAWS:
        render_frame(scene, view_block(yaw, proj, dev), fp, mats, overlay,
                     settings, ibl=ibl,
                     kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres = check_kernels_c5(calls)
    for k, v in kres.items():
        print(f"kernel {k}: " + json.dumps(v))
    del calls

    vbs = [view_block(y, proj, dev) for y in C5_YAWS]
    counters = (fused.raster_tiles, shade_sampled, sort_keys,
                fused.overlay_tiles, shade_tonemap,
                tq.sample_table_block_kernel, tq.sample_rows_small)
    shadow = shadow_fields()
    for fn in counters:
        fn.launches = 0
    cover: list = []
    shadow_launches = [0]

    def raster_counted(*args, **kw):
        before = fused.raster_tiles.launches
        zk, f = KERNELS.raster(*args, **kw)
        if tuple(args[11]) == shadow:
            shadow_launches[0] += fused.raster_tiles.launches - before
        else:
            cover.append(f[args[11].index("idf")] >= 0.5)
        return zk, f

    counted = KERNELS._replace(raster=raster_counted)
    outs, frame_ms = [], []
    for vb in vbs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_frame(scene, vb, fp, mats, overlay, settings, ibl=ibl,
                           kernels=counted)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((out, cover[0]))
        cover.clear()
    launches = {"raster": fused.raster_tiles.launches - shadow_launches[0],
                "raster_shadow_pass": shadow_launches[0],
                "shade": shade_sampled.launches,
                "sort": sort_keys.launches,
                "overlay": fused.overlay_tiles.launches,
                "shade_gbuffer": shade_tonemap.launches,
                "sample_block": tq.sample_table_block_kernel.launches,
                "sample_small": tq.sample_rows_small.launches}
    print("config-5 main-path launches: " + json.dumps(launches))
    for k, n in launches.items():
        if n <= 0 and k != "shade":
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "config-5 frame")

    for i, ((out, cov), vb) in enumerate(zip(outs, vbs)):
        ref = render_frame(scene, vb, fp, mats, overlay, settings, ibl=ibl,
                           kernels=PLAIN)["image"]
        summary = check_frame(i, out, cov, ref, (C5_HEIGHT, C5_WIDTH, 3),
                              "config-5")
        print(f"config-5 frame {i}: yaw {C5_YAWS[i]}, {frame_ms[i]:.2f} ms, "
              + summary)
    print(f"config-5 frame time median: {statistics.median(frame_ms):.2f} "
          f"ms (host clock around render_frame + synchronize, {name}, "
          f"{smi})")
    return kres, launches


def cube_inputs(dev, caps=C2_CAPS):
    """Config 2: CubeScene, the cube binding from seeded stand-in albedos,
    the bench's settings (two materials by batch, no light spheres, no
    gizmo) with explicit capacities."""
    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import FrameParams, RenderSettings
    from bibim_tpu_torch.scene.cube import (
        CubeScene,
        cube_material_tables,
        seeded_albedos,
    )

    scene = CubeScene(device=dev)
    mats = cube_material_tables(seeded_albedos(SEED, C2_ALBEDOS), device=dev)
    proj = m3.perspective(60.0, C2_WIDTH / C2_HEIGHT, 0.1, 1000.0,
                          device=dev)
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(1, dtype=torch.int32, device=dev),
        exposure=torch.tensor(1.0, dtype=torch.float32, device=dev))
    settings = RenderSettings(width=C2_WIDTH, height=C2_HEIGHT,
                              outputs="image+diag", show_gizmo=False,
                              show_lights=False,
                              batch_material_ids=scene.material_ids, **caps)
    return scene.scene_data(), mats, proj, fp, settings


def cube_view(z: float, proj, dev):
    """The default camera moved to (0, 0, z) along its view axis."""
    import numpy as np
    import torch

    from bibim_tpu_torch.pipeline import ViewBlock
    from bibim_tpu_torch.scene.camera import FreeLookCamera

    cam = FreeLookCamera(pos=np.asarray([0.0, 0.0, z], np.float32))
    return ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=dev),
        proj=proj,
        view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(0, dtype=torch.int32, device=dev))


def c2_frames(settings, proj, dev) -> list:
    """(label, view block, settings) of the config-2 path: the bench frame
    at each camera position, then the G-buffer views of the first."""
    import dataclasses

    from bibim_tpu_torch.pipeline import GBufferViz

    frames = [(f"view z={z}", cube_view(z, proj, dev), settings)
              for z in C2_CAMERA_Z]
    frames += [(f"G-buffer view {v}", frames[0][1], dataclasses.replace(
        settings, gbuffer_viz=GBufferViz[v])) for v in C2_VIEWS]
    return frames


def level_evidence(table, call) -> dict:
    """Histogram of the selected level l0 over the covered pixels of one
    K2 call, and the share of them with 0 < frac < 1."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq

    args, kw = call
    g = tq._mip_block_geometry(table, kw["mat_id"], args[1], args[2],
                               kw["tile_h"], kw["tile_w"])
    valid = args[6]
    l0, frac = g["l0"][valid], g["frac"][valid]
    hist = torch.bincount(l0.long()).tolist()
    return dict(pixels=int(valid.sum()),
                l0_hist={i: n for i, n in enumerate(hist) if n},
                blend_share=float(((frac > 0) & (frac < 1)).float().mean()))


def check_kernels_c2(calls: dict) -> dict:
    """K1, K3, K2 with the mip-block and routed small groups, K8 and K7
    (routed rows) vs their plain versions on the config-2 frames' own
    inputs; K2 and K8 must be bit-equal."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain

    res = {"raster": check_raster(calls["raster"][0]),
           "sort": check_sorts(calls["sort"])}
    for args, kw, _ in calls["shade"]:
        got = shade_sampled(*args, **kw)
        want = shade_sampled_plain(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            raise AssertionError(f"K2 with mip groups differs from its "
                                 f"plain version by {err}")
    args, kw, _ = calls["shade"][0]
    res["shade"] = dict(
        max_abs_err=0.0, calls=len(calls["shade"]),
        pixels=int(args[1].numel()),
        groups=[type(t).__name__ for t in args[0]],
        ms=cuda_ms(lambda: shade_sampled(*args, **kw)),
        plain_ms=cuda_ms(lambda: shade_sampled_plain(*args, **kw)))
    for call in calls["sample_mip_block"][1:]:
        check_sampler(call, tq.sample_mip_block_kernel, tq.sample_mip_block,
                      "K8")
    res["sample_mip_block"] = check_sampler(
        calls["sample_mip_block"][0], tq.sample_mip_block_kernel,
        tq.sample_mip_block, "K8")
    res["sample_small"] = check_sampler(
        calls["sample_small"][0], tq.sample_rows_small,
        tq.sample_rows_small_plain, "K7 routed")
    return res


def run_config2(dev, smi: str, name: str):
    """The textured-cube trilinear-mip path: kernel phases, then the
    counted frames with the level evidence."""
    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.shading import shade_sampled
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame

    t0 = time.perf_counter()
    scene, mats, proj, fp, settings = cube_inputs(dev)
    block = mats[0]
    print(f"config-2 frame: {C2_WIDTH}x{C2_HEIGHT}, 2 cubes, materials by "
          f"batch {settings.batch_material_ids}, lights "
          f"{scene.lights.num_lights}, no light spheres, no gizmo; stand-in "
          f"albedos {C2_ALBEDOS} (seed {SEED}); binding built in "
          f"{time.perf_counter() - t0:.1f} s: "
          + json.dumps([[type(t).__name__, list(t[0].shape), t.heights]
                        for t in mats]))
    print("config-2 capacities: " + json.dumps(C2_CAPS))
    frames = c2_frames(settings, proj, dev)

    calls: dict = {}
    for _, vb, s in frames:
        render_frame(scene, vb, fp, mats, None, s,
                     kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres = check_kernels_c2(calls)
    for k, v in kres.items():
        print(f"kernel {k} (config 2): " + json.dumps(v))
    del calls

    counters = (fused.raster_tiles, sort_keys, shade_sampled,
                tq.sample_rows_small, tq.sample_mip_block_kernel)
    for fn in counters:
        fn.launches = 0
    cover: list = []
    shades: list = []

    def raster_cover(*args, **kw):
        zk, f = KERNELS.raster(*args, **kw)
        cover.append(f[args[11].index("idf")] >= 0.5)
        return zk, f

    def shade_kept(*args, **kw):
        shades.append((args, kw))
        return KERNELS.shade(*args, **kw)

    counted = KERNELS._replace(raster=raster_cover, shade=shade_kept)
    outs, frame_ms = [], []
    for _, vb, s in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_frame(scene, vb, fp, mats, None, s, kernels=counted)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((out, cover[-1]))
    launches = {"raster": fused.raster_tiles.launches,
                "sort": sort_keys.launches,
                "shade": shade_sampled.launches,
                "sample_small": tq.sample_rows_small.launches,
                "sample_mip_block": tq.sample_mip_block_kernel.launches}
    print("config-2 main-path launches: " + json.dumps(launches))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "config-2 frames")

    levels = set()
    blend = []
    for (label, _, _), shade in zip(frames, shades):
        ev = level_evidence(block, shade)
        levels |= set(ev["l0_hist"])
        blend.append(ev["blend_share"])
        print(f"config-2 levels, {label}: " + json.dumps(ev))
    if len(levels) < 3 or not max(blend) > 0.0:
        raise AssertionError(f"config-2 frames selected levels "
                             f"{sorted(levels)}, blend shares {blend}: "
                             "trilinear blending across ≥3 levels not shown")

    for i, ((out, cov), (label, vb, s)) in enumerate(zip(outs, frames)):
        ref = render_frame(scene, vb, fp, mats, None, s,
                           kernels=PLAIN)["image"]
        summary = check_frame(i, out, cov, ref, (C2_HEIGHT, C2_WIDTH, 3),
                              "config-2")
        print(f"config-2 frame {i}: {label}, {frame_ms[i]:.2f} ms, "
              + summary)
    print(f"config-2 frame time median (views): "
          f"{statistics.median(frame_ms[:len(C2_CAMERA_Z)]):.2f} ms (host "
          f"clock around render_frame + synchronize, {name}, {smi})")
    return kres, launches


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
        ref = render_frame(scene, vb, fp, mats, overlay, settings,
                           kernels=PLAIN)["image"]
        summary = check_frame(i, out, cov, ref, (HEIGHT, WIDTH, 3), "1080p")
        print(f"frame {i}: yaw {YAWS[i]}, {frame_ms[i]:.2f} ms, " + summary)
    print(f"frame time median: {statistics.median(frame_ms):.2f} ms "
          f"(host clock around render_frame + synchronize, {name}, {smi})")
    del outs

    kres5, launches5 = run_config5(dev, smi, name)
    kres2, launches2 = run_config2(dev, smi, name)

    # One row per kernel and path: K1-K4 on the 1080p path, every kernel
    # the config-5 path runs (K1 twice: main and shadow pass), then every
    # kernel of the config-2 path (K2 with the mip groups, K8, K7 routed).
    rows = [(k, KERNEL_INFO[k][0] + ", 1080p", kres[k], launches[k])
            for k in kres]
    rows += [(k, KERNEL_INFO[k][0] + ", config-5 4K", kres5[k],
              launches5[k]) for k in kres5 if k in KERNEL_INFO]
    rows.append(("raster", KERNEL_INFO["raster"][0]
                 + ", config-5 shadow pass", kres5["raster_shadow_pass"],
                 launches5["raster_shadow_pass"]))
    rows += [(k, KERNEL_INFO[k][0] + ", config-2 720p cubes", kres2[k],
              launches2[k]) for k in kres2]
    kernels = []
    for k, label, r, n in rows:
        _, src, repl = KERNEL_INFO[k]
        kernels.append({"name": label, "route": "cuda", "source": src,
                        "replaces": repl, "launches": n,
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
