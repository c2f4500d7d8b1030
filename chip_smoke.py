#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bibim_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the eleven CUDA kernels from ``bibim_tpu_torch/csrc`` (into
   ``build/``, one nvcc per source in parallel) and prints the build time
   and, per kernel instantiation, ptxas's registers, stack frame and spill
   bytes (every K2 and K5 instantiation must have a 0-byte stack frame
   and no spills);
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
   timings; K2 and K5 also kernel-only by ``torch.profiler``, with and
   without their fused fp16 + tone-map tail, which must equal the frame's
   torch tail, ``torch.equal``, on every captured call of every path);
   sizes ``group_pair_cap`` from the port's capacity probe and
   checks K10 (group window) on that frame; renders 4 frames at 4 camera
   yaws through ``render_frame`` with launch counters reset just before,
   then the group-window frame with the counters reset again (it must
   equal the default frame of its yaw);
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
6. the 1920×1080 instanced path (BASELINE config 4: 64 instances of the
   stand-in ball, 640,002 triangles before culling): three views (the
   bench camera, orbits to yaw -25 and yaw -45: 16-, 32- and 64-instance
   buckets), each culled on the host and autotuned three ways — default
   (multi-pass K1 with the merged slot order), ``early_z`` (K9 on every
   pass) and ``fine_bins`` (K11 on pass 0) — with the dense-pass slot
   count picked by the candidates' frame device time
   (:func:`pick_dense_cap`); prints the probes, the derived settings and
   the culled instance counts; checks K1, K3, K2, K9 (with its
   skipped-chunk share) and K11 against their plain versions on those
   frames' inputs, and prints every default frame's K1 launches with
   their bound; renders the nine frames with the counters reset just
   before; the default and early-z frames must equal the all-plain
   render of the default settings; a fine-bin frame may differ from them
   only at masked-key ties and where the default winner's bounding box
   misses the pixel (``c4_fine_vs_default``);
7. checks, on every frame, zero capacity drops (shadow pass included),
   coverage, that the image is not background, and the frame against the
   all-plain render of the same frame at the golden-image bound;
8. prints the GPU's ``nvidia-smi`` name/power-limit line, one JSON line of
   kernel results (per kernel and path: launches on the main path and the
   frames they cover, error against the plain version, wrapper and plain
   times, the bound of the bytes and operations the call needs on an H100
   SXM, ``torch.sort``'s time for K3) and, last, ``{"ok": true, "device":
   {...}}``.

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
# BASELINE config 4 (bench.py bench_instanced): 64 instances, 1080p, no
# light spheres, no gizmo, autotuned at the bench's margin; pair sampling
# is not ported (base pair_sampling=0). Views: the bench camera (14 of 64
# instances in view: bucket 16), orbits to yaw -25 (28: bucket 32) and to
# yaw -45 (60: bucket 64, 640,002 triangles, so the early-z pair key has no
# room in 31 bits and sorts as int64 with a 16-bit depth bucket).
C4_INSTANCES = 64
C4_VIEWS = (("bench camera", 0.0, 0.0), ("yaw -25", -25.0, 0.0),
            ("yaw -45", -45.0, 0.0))
C4_MODES = (("default", {}), ("early_z", {"early_z": True}),
            ("fine_bins", {"fine_bins": True}))
C4_MARGIN = 1.05
# Bounds: NVIDIA's H100 SXM data sheet (3.35 TB/s HBM3, 67 TFLOP/s fp32
# outside the tensor cores), and the operations each kernel does per unit
# of work: a candidate × pixel coverage test (5 plane evaluations, the
# reciprocal, the key) and a pixel's resolve (barycentrics, depth, 16
# blended channels); shading and sampling per pixel.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
COVER_OPS = 25
COVER_CH = 15  # coverage floats a raster kernel reads per candidate
RESOLVE_OPS = 100
SAMPLE_TAP_OPS = 8  # per tap and output channel (4 weights, 4 fma)
LIGHT_OPS = 80  # GGX per light and pixel
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
    "raster_earlyz": ("K9 early-z raster",
                      "bibim_tpu_torch/csrc/raster_earlyz.cu",
                      "bibim_tpu/ops/fused.py:589"),
    "raster_gw": ("K10 group-window raster",
                  "bibim_tpu_torch/csrc/raster_gw.cu",
                  "bibim_tpu/ops/fused.py:1085"),
    "raster_fine": ("K11 fine-subtile raster",
                    "bibim_tpu_torch/csrc/raster_fine.cu",
                    "bibim_tpu/ops/fused.py:905"),
}


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def ptxas_usage(log: str) -> dict:
    """Per kernel of the library (``bb::`` entry functions, demangled with
    ``c++filt`` where the machine has it): registers, stack frame and
    spill bytes from ``nvcc -Xptxas -v`` output."""
    import re
    import shutil

    names = sorted(set(re.findall(r"Compiling entry function '(\w+)'", log)))
    pretty = dict(zip(names, names))
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        for m, d in zip(names, out.stdout.splitlines()):
            k = re.search(r"bb::(\w+(<[^>]*>)?)", d)
            pretty[m] = k.group(1) if k else d
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            fn = m.group(1) if m.group(1) in pretty else None
            continue
        if fn is None:
            continue
        row = usage.setdefault(pretty[fn], {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    return usage


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


def device_ms(fn, reps: int = 3, match: str | None = None) -> float:
    """Device milliseconds per ``fn`` call, after one warm-up: the summed
    time of the device-side events (kernels, memcpy, memset) that ``reps``
    calls put on the card under ``torch.profiler``; with ``match``, only
    the kernels whose name contains it. Unlike CUDA events around a
    host-bound call, it does not count the gaps the host leaves."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (match is None or match in e.key))
    if not us > 0:
        raise AssertionError("torch.profiler recorded no device time"
                             + (f" for {match}" if match else ""))
    return us / 1e3 / reps


def pick_dense_cap(cands, data, vb, fp, mats):
    """:func:`pick_measured` over config-4 settings candidates by each
    frame's device time (:func:`device_ms` over 3 renders)."""
    from bibim_tpu_torch.pipeline import render_frame
    from bibim_tpu_torch.pipeline.autotune import pick_measured

    return pick_measured(cands, lambda sx: device_ms(
        lambda: render_frame(data, vb, fp, mats, None, sx), reps=3))


def check_tails(calls: dict, what: str) -> int:
    """Every captured K2 / K5 call whose frame lets the kernel write the
    LDR planes (the fused fp16 + tone-map tail) against the same kernel's
    HDR output finished by the frame's torch tail (ops.shading.hdr_tail):
    ``torch.equal``. Returns the number of calls held."""
    import torch

    from bibim_tpu_torch.ops.shading import (
        hdr_tail,
        shade_sampled,
        shade_tonemap,
    )

    n = 0
    for name, fn, tail in (("shade", shade_sampled,
                            ("quantize_hdr", "tonemap")),
                           ("shade_gbuffer", shade_tonemap,
                            ("quantize", "tonemap"))):
        for args, kw, _ in calls.get(name, []):
            q, tm = (bool(kw.get(k, False)) for k in tail)
            if not (q or tm):
                continue
            hdr = fn(*args, **dict(kw, **{k: False for k in tail}))
            if name == "shade":
                enable, expo = kw["enable_tone_mapping"], kw["exposure"]
            else:
                enable, expo = args[9], args[10]
            want = hdr_tail(hdr, q, tm, enable, expo)
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            for c in range(3):
                if not torch.equal(got[c], want[c]):
                    bad = got[c] != want[c]
                    raise AssertionError(
                        f"{what} {name}: the fused tail differs from the "
                        f"torch tail at {int(bad.sum())} values (HDR "
                        f"{hdr[c][bad][:3].tolist()}: fused "
                        f"{got[c][bad][:3].tolist()}, torch "
                        f"{want[c][bad][:3].tolist()})")
            n += 1
    return n


def build_inputs(dev, width=WIDTH, height=HEIGHT, caps=CAPS, **extra):
    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import (
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
    mats = standin_materials(dev)
    # No device argument: the port's entry points build on the card.
    overlay = make_overlay_resources(with_gizmo=False)
    if overlay.sphere_positions.device.type != "cuda":
        raise AssertionError("make_overlay_resources() built on "
                             f"{overlay.sphere_positions.device}")
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


def tensor_bytes(*objs) -> int:
    """Bytes of every distinct tensor in nested args (tuples, lists, dicts,
    NamedTuples such as the material tables)."""
    import torch

    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel(), x.dtype)
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    for o in objs:
        walk(o)
    return total


def field_channels(out_fields) -> int:
    """Record channels a raster kernel's resolve needs per winner for the
    output planes ``out_fields`` (ops/fused.py record layout): the
    barycentric planes need the edge rows, and every plane but ``matf``
    the hit test on ``_ID``."""
    from bibim_tpu_torch.ops import fused as f

    def rng(base, n=3):
        return set(range(base, base + n))

    bary = rng(f._A, 9) | {f._ID}
    need = {"depth": rng(f._ZC, 6) | {f._ID}, "idf": {f._ID},
            "matf": {f._MAT}, "b0": bary, "b1": bary,
            "u": bary | rng(f._U), "v": bary | rng(f._V)}
    for j, axis in enumerate("xyz"):
        need["n" + axis] = bary | rng(f._N + 3 * j)
        need["t" + axis] = bary | rng(f._T + 3 * j)
        need["w" + axis] = bary | rng(f._W + 3 * j)
    for j, c in enumerate("rgb"):
        need["c" + c] = bary | rng(f._COL + 3 * j)
    return len(set().union(*(need[x] for x in out_fields)))


def window_rows(pair_len: int, lo, n):
    """(pair_len,) bool: the pair-list rows inside any window [lo, lo + n)
    (flattened, clipped to the list)."""
    import torch

    lo = lo.reshape(-1).long().clamp(0, pair_len)
    hi = torch.maximum((lo + n.reshape(-1).long().clamp(min=0)).clamp(
        max=pair_len), lo)
    d = torch.zeros(pair_len + 1, dtype=torch.int64, device=lo.device)
    d.index_add_(0, lo, torch.ones_like(lo))
    d.index_add_(0, hi, -torch.ones_like(hi))
    return d.cumsum(0)[:pair_len] > 0


def n_distinct(t) -> int:
    import torch

    t = t.reshape(-1)
    return int(torch.unique(t[t >= 0]).numel())


def raster_bytes(name: str, args, out, window_share: float = 1.0) -> int:
    """Bytes one raster-kernel call (K1, K9, K10, K11; K4 as "overlay")
    must move: the 15 coverage floats of each distinct candidate of the
    overflow list and of the windows its slots scan (K9: also the draw
    order and depth bound; ``window_share`` of the window candidates, the
    share of chunks its break left), the pair-list rows of those windows,
    the per-slot window ids, the initial planes, the record channels of
    each distinct winner that its output planes need, and the outputs.
    Pad instances, unused channels and rows outside the windows are not
    read, so they do not count."""
    import torch

    from bibim_tpu_torch.ops import fused

    rec, big_ids, n_big, pair_tri, ids = args[:5]
    nb = min(int(n_big[0]), big_ids.shape[0])
    k = ids.shape[0]
    if name == "raster_gw":
        win, lb_al, cnt, init, group = args[5], args[6], args[7], args[8], \
            args[9]
        lo, index = win.repeat_interleave(group) + lb_al, (win, lb_al, cnt)
    elif name == "raster_fine":
        starts, lb_al, cnt, init = args[5], args[6], args[7], args[8]
        lo, index = starts[:, None] + lb_al, (starts, lb_al, cnt)
    elif name == "overlay":
        k = int(args[7])  # live slots; the rest are skipped
        starts, cnt, ids = args[5][:k], args[6][:k], ids[:k]
        lo, index = starts, (starts, cnt)
        init = args[8][ids.long()]
    else:
        starts, cnt, init = args[5], args[6], args[7]
        lo, index = starts, (starts, cnt)
    inwin = window_rows(pair_tri.shape[0], lo, cnt)
    big = big_ids[:nb]
    n_big_c = n_distinct(big)
    n_win_c = n_distinct(torch.cat([big, pair_tri[inwin]])) - n_big_c
    per_cand = COVER_CH
    if name == "raster_earlyz":
        per_cand += 2  # _ID (draw order) and _ZUB (the break's bucket)
        init = (init, args[8])
    cands = n_big_c + n_win_c * window_share
    nbytes = (cands * per_cand * 4 + int(inwin.sum()) * 4 + nb * 4 + 4
              + 4 * ids.numel() + sum(4 * t[:k].numel() for t in index)
              + tensor_bytes(init))
    if name == "overlay":
        # Winners by the plain scan of the live slots; the output is a new
        # image (the LDR planes read once, written once).
        px, py = fused._pixel_centres(ids, args[10], args[11], args[12])
        _, best = fused._scan_plain(rec, big_ids, n_big, pair_tri, starts,
                                    cnt, init, px, py)
        chans = field_channels(("cr", "cg", "cb"))
        return int(nbytes + n_distinct(best) * chans * 4
                   + 2 * tensor_bytes(args[9]))
    out_fields = args[-1]
    fields = out[-1]
    if "idf" not in out_fields:
        # The winners of the same call with every plane (the scan does not
        # depend on the planes asked for).
        kern = getattr(fused, RASTER_FNS[name][0])
        fields = kern(*args[:-1], fused._OUT_FIELDS)[-1]
        idf = fields[fused._OUT_FIELDS.index("idf")]
    else:
        idf = fields[out_fields.index("idf")]
    winners = n_distinct(torch.where(idf >= 0.5, torch.round(idf) - 1,
                                     torch.full_like(idf, -1.0)))
    return int(nbytes + winners * field_channels(out_fields) * 4
               + tensor_bytes(out))


def table_rows(table, u, v, mat_id, tile_h: int, tile_w: int):
    """The row of material table ``table`` each pixel reads (its layout's
    footprint, as the samplers compute it)."""
    from bibim_tpu_torch.ops import texture_quad as tq

    if isinstance(table, tq.BlockTable):
        x0, y0, _, _ = tq._footprint_ints(u, v, table.height, table.width)
        return (y0 // tq.BLOCK_B) * (table.width // tq.BLOCK_B) \
            + x0 // tq.BLOCK_B
    if isinstance(table, tq.QuadTable):
        return tq._footprint(u, v, table.height, table.width)[0]
    if isinstance(table, tq.MipBlockMulti):
        return tq._mip_block_geometry(table, mat_id, u, v, tile_h,
                                      tile_w)["idx"]
    return tq.small_footprint_multi(table, mat_id, u, v)[0]


def rows_bytes(tab, rows) -> int:
    """Bytes of the distinct in-range rows ``rows`` of table ``tab``."""
    r = rows.reshape(-1)
    r = r[(r >= 0) & (r < tab.shape[0])]
    return n_distinct(r) * tab.shape[1]


def tables_bytes(tables, u, v, mat_id, tile_h, tile_w, mask=None) -> int:
    """Bytes of the distinct table rows the pixels of ``mask`` (default:
    all) read, over every table of a material binding."""
    total = 0
    for t in tables:
        rows = table_rows(t, u, v, mat_id, tile_h, tile_w).reshape(-1)
        if mask is not None:
            rows = rows[mask.reshape(-1)]
        total += rows_bytes(t.blocks if hasattr(t, "blocks") else t.quads,
                            rows)
    return total


def bound(nbytes: int, ops: float) -> dict:
    """The least time of the work on an H100 SXM: its bytes (inputs read
    once, outputs written once) at the HBM rate, or its operations at the
    fp32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(nbytes), ops=float(ops))


def raster_tests(name: str, args, scanned_rows=None) -> float:
    """Candidate × pixel coverage tests of one raster-kernel call (K9: the
    window rows its break left scanned)."""
    nb = int(args[2][0])
    if name == "raster_fine":
        lb_al, cntk, tile_h, tile_w = args[6], args[7], args[10], args[11]
        spx = tile_h * tile_w // cntk.shape[1]
        return float((nb * cntk.numel() + int(cntk.sum())) * spx)
    if name == "raster_gw":
        cnt, tile_h, tile_w = args[7], args[11], args[12]
    elif name == "raster_earlyz":
        cnt, tile_h, tile_w = args[6], args[11], args[12]
    else:
        cnt, tile_h, tile_w = args[6], args[9], args[10]
    rows = int(cnt.sum()) if scanned_rows is None else scanned_rows
    return float((nb * cnt.numel() + rows) * tile_h * tile_w)


RASTER_FNS = {"raster": ("raster_tiles", "raster_tiles_plain"),
              "raster_earlyz": ("raster_tiles_earlyz",
                                "raster_tiles_earlyz_plain"),
              "raster_gw": ("raster_tiles_gw", "raster_tiles_gw_plain"),
              "raster_fine": ("raster_tiles_fine", "raster_tiles_fine_plain")}


def check_raster(call, name: str = "raster", calls=()) -> dict:
    """A raster kernel (K1, K9, K10, K11) on one captured call, timed, and
    on every call in ``calls`` too: K1's zkey and tri_id bit-equal to the
    plain raster and its attribute planes within tests/test_fused.py's
    bound; K9-K11 bit-equal in every output. K9 runs with its chunk
    counter: the share of window chunks its break skipped."""
    import torch

    from bibim_tpu_torch.ops import fused

    kern = getattr(fused, RASTER_FNS[name][0])
    plain = getattr(fused, RASTER_FNS[name][1])
    err = 0.0
    stats = None
    skipped = None
    for args, kw, _ in [call, *calls]:
        kwk = dict(kw)
        if name == "raster_earlyz":
            stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
            kwk["stats"] = stats
        got = kern(*args, **kwk)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if name != "raster":
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: differs from its plain "
                                         "version")
            continue
        zk, f = got
        zk_p, f_p = want
        idf = args[-1].index("idf")
        if not torch.equal(zk, zk_p) or not torch.equal(f[idf], f_p[idf]):
            raise AssertionError("K1: zkey / tri_id differ from the plain "
                                 "raster")
        err = max(err, float((f - f_p).abs().max()))
        if err > 1e-3:
            raise AssertionError(f"K1 attribute planes differ by {err}")
    args, kw, _ = call
    scanned_rows = None
    share = 1.0
    if name == "raster_earlyz":
        stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
        kern(*args, **kw, stats=stats)
        torch.cuda.synchronize()
        scanned, present = stats.tolist()
        scanned_rows = 8 * scanned
        share = scanned / max(present, 1)
        skipped = 1.0 - share
    out = kern(*args, **kw)
    res = dict(max_abs_err=err, slots=int(args[4].shape[0]),
               checked_calls=1 + len(calls), planes=len(args[-1]),
               ms=cuda_ms(lambda: kern(*args, **kw)),
               plain_ms=cuda_ms(lambda: plain(*args, **kw)),
               library_ms=None, whole_tensor_bytes=tensor_bytes(args, out),
               **raster_bound(name, args, out, share, scanned_rows))
    if skipped is not None:
        res["skipped_chunk_share"] = skipped
    if name == "raster":
        res.update(k1_launch(args, kw))
    return res


def raster_bound(name: str, args, out, share: float = 1.0,
                 scanned_rows=None) -> dict:
    """:func:`bound` of one raster-kernel call: :func:`raster_bytes`, and
    its coverage tests and per-pixel resolves as operations."""
    tile_h, tile_w = (args[-3], args[-2])
    ops = (raster_tests(name, args, scanned_rows) * COVER_OPS
           + args[4].shape[0] * tile_h * tile_w * RESOLVE_OPS)
    return bound(raster_bytes(name, args, out, share), ops)


def k1_launch(args, kw) -> dict:
    """One K1 call as its launch sees it: slots, the window lengths
    (``counts``, read on the host after the frame), the overflow entries
    every slot scans first, the cluster size the wrapper picks, and the
    kernel's device time at every cluster size (:func:`graph_ms`)."""
    from bibim_tpu_torch.ops import fused

    counts = args[6].cpu()
    k = int(args[4].shape[0])
    live = counts[counts > 0]
    return dict(
        slots=k, window_max=int(counts.max()) if k else 0,
        window_mean=float(counts.float().mean()) if k else 0.0,
        live_slots=int(live.numel()),
        live_window_mean=float(live.float().mean()) if live.numel() else 0.0,
        overflow=int(args[2][0]),
        cluster=fused.raster_cluster(k, kw.get("max_count")),
        kernel_ms_by_cluster={c: graph_ms(lambda: fused.raster_tiles(
            *args, **kw, cluster=c)) for c in fused.CLUSTER_SIZES})


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one ``fn`` call: ``fn`` captured once in a
    CUDA graph and replayed ``reps`` times between two CUDA events, so no
    host work (checks, allocation, ctypes) falls inside the timed span."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations of the first call stay out of the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_sorts(calls: list) -> dict:
    """K3 on every captured sort (bit-equal to torch.sort); the largest
    is timed, beside one torch.sort of the same keys (the library call),
    and on every route that can sort it (``route``: the one it takes)."""
    import math

    import torch

    from bibim_tpu_torch import _build
    from bibim_tpu_torch.ops.sort import digit_plan, sort_keys, sort_keys_plain

    per_sort = {}
    for args, _, _ in calls:
        keys = args[0]
        before = sort_keys.device_launches
        got, want = sort_keys(keys), sort_keys_plain(keys)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 sort of {tuple(keys.shape)} "
                                 f"{keys.dtype} differs from torch.sort")
        launched = sort_keys.device_launches - before
        plan = len(digit_plan(keys))
        if launched > 2 + plan:
            raise AssertionError(f"K3 made {launched} device launches for "
                                 f"keys with {plan} non-constant digits")
        row = per_sort.setdefault((keys.numel(), str(keys.dtype)), dict(
            keys=keys.numel(), dtype=str(keys.dtype), sorts=0,
            device_launches=launched, nonconstant_digits=set()))
        row["sorts"] += 1
        row["nonconstant_digits"].add(plan)
    keys = max((c[0][0] for c in calls), key=lambda k: k.numel())
    n = keys.numel()
    return dict(max_abs_err=0.0, sorts=len(calls), shape=list(keys.shape),
                dtype=str(keys.dtype),
                dtypes=sorted({str(c[0][0].dtype) for c in calls}),
                device_launches_per_sort=[
                    dict(r, nonconstant_digits=sorted(r["nonconstant_digits"]))
                    for r in sorted(per_sort.values(),
                                    key=lambda r: -r["keys"])],
                ms=cuda_ms(lambda: sort_keys(keys)),
                plain_ms=cuda_ms(lambda: sort_keys_plain(keys)),
                library_ms=cuda_ms(lambda: torch.sort(keys)),
                host_ms=host_ms(lambda: sort_keys(keys)),
                library_host_ms=host_ms(lambda: torch.sort(keys)),
                route=_build.library().bb_sort_cluster(n,
                                                       keys.element_size()),
                ms_by_route={r: loop_ms(lambda: sort_keys(keys, route=r))
                             for r in sort_routes(keys)},
                library_loop_ms=loop_ms(lambda: torch.sort(keys)),
                **bound(2 * tensor_bytes(keys), n * math.log2(max(n, 2))))


def sort_routes(keys) -> list:
    """K3's routes for these keys: many blocks (0), then every cluster
    size whose shared memory holds them."""
    from bibim_tpu_torch import _build

    lib = _build.library()
    n, size = keys.numel(), keys.element_size()
    return [r for r in (0, 1, 2, 4, 8, 16)
            if lib.bb_sort_work_bytes(n, size, r) >= 0]


def loop_ms(fn, reps: int = 20) -> float:
    """Milliseconds per ``fn`` call over ``reps`` calls issued back to
    back between two CUDA events (after one warm-up): the device time
    where that exceeds the call's host cost."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Host milliseconds per ``fn`` call over ``reps`` calls issued back to
    back (one synchronize at the end): the call's host cost where that
    exceeds its device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def k3_device_line(what: str) -> str:
    """K3's launches on a main path: wrapper calls and the device launches
    they made (its count since the path's counters were reset)."""
    from bibim_tpu_torch.ops.sort import sort_keys

    return (f"{what} K3 launches: {sort_keys.launches} sorts, "
            f"{sort_keys.device_launches} device launches")


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
    n_live, nb = int(args[7]), int(args[2][0])
    npx = args[11] * args[12]
    tests = (nb * n_live + int(args[6][:n_live].sum())) * npx
    ops = tests * COVER_OPS + n_live * npx * RESOLVE_OPS
    return dict(max_abs_err=0.0, live_slots=n_live,
                pixels_changed=changed,
                ms=cuda_ms(lambda: fused.overlay_tiles(*args, **kw)),
                plain_ms=cuda_ms(lambda: fused.overlay_tiles_plain(*args,
                                                                   **kw)),
                library_ms=None, whole_tensor_bytes=tensor_bytes(args, got),
                **bound(raster_bytes("overlay", args, got), ops))


def shade_bound(args, kw, out, tap_channels: int,
                sampled: bool = True) -> dict:
    """Bound of a shading kernel call (K2 ``sampled``, K5): the valid
    plane read whole, the other input planes only at valid pixels (the
    output is 0 elsewhere), K2's material tables as the distinct rows the
    valid pixels read, the lights, the three output planes written once;
    per valid pixel the light loop and ``tap_channels`` material taps ×
    channels."""
    from bibim_tpu_torch.ops import texture_quad as tq

    valid, lights = args[6], args[7]
    nv = int(valid.sum())
    opt = [kw.get("vis_plane")]
    if sampled:
        tables = args[0]
        routed = any(isinstance(t, (tq.MipBlockMulti, tq.MipQuadMulti))
                     for t in tables)
        n_planes = 11 + (routed and kw.get("mat_id") is not None)
        tabs = tables_bytes(tables, args[1], args[2], kw.get("mat_id"),
                            kw.get("tile_h", 8), kw.get("tile_w", 128),
                            valid)
    else:
        n_planes, tabs = 12, 0
        opt += list(kw.get("ambient") or ())
    n_planes += sum(t is not None for t in opt)
    nbytes = (valid.numel() + 4 * n_planes * nv + tabs
              + tensor_bytes(args[7:]) + tensor_bytes(out))
    ops = nv * (lights.num_lights * LIGHT_OPS
                + tap_channels * SAMPLE_TAP_OPS)
    return dict(whole_tensor_bytes=tensor_bytes(args, kw, out),
                valid_pixels=nv, **bound(nbytes, ops))


def shade_times(kern, plain, args, kw, hdr_kw) -> dict:
    """A shading kernel's times on one call as the frame makes it: the
    wrapper (:func:`cuda_ms`), the kernel alone and the kernel without
    the fused tail (``hdr_kw``; :func:`device_ms` of the ``bb::`` kernel),
    and the plain version. Where the time goes inside the kernel, on the
    same inputs: with no lights (sampling, G-buffer and writes: the light
    loop's share is the difference) and with every pixel a miss (the
    coverage read and the writes). K2 also runs its generic instantiation
    (``generic_kernel_ms``; its output must be the same bits) beside the
    one compiled for the binding's group layout."""
    import torch

    name = ("bb::shade_kernel" if kern.__name__ == "shade_sampled"
            else "bb::gbuffer_shade_kernel")
    lights = args[7]
    dark = args[:7] + (lights._replace(**{
        f: getattr(lights, f)[:0] for f in lights._fields}),) + args[8:]
    empty = args[:6] + (torch.zeros_like(args[6]),) + args[7:]

    def kernel_ms(a, **extra):
        return device_ms(lambda: kern(*a, **kw, **extra), 20, name)

    res = dict(ms=cuda_ms(lambda: kern(*args, **kw)),
               kernel_ms=kernel_ms(args),
               hdr_kernel_ms=device_ms(lambda: kern(*args, **hdr_kw), 20,
                                       name),
               no_lights_kernel_ms=kernel_ms(dark),
               all_miss_kernel_ms=kernel_ms(empty),
               plain_ms=cuda_ms(lambda: plain(*args, **kw)))
    if name == "bb::shade_kernel":
        got, generic = kern(*args, **kw), kern(*args, **kw, generic=True)
        torch.cuda.synchronize()
        if not all(torch.equal(g, x) for g, x in zip(got, generic)):
            raise AssertionError("K2's generic instantiation differs from "
                                 "the one compiled for the binding")
        res["generic_kernel_ms"] = kernel_ms(args, generic=True)
        res["layout"] = k2_layout(args, kw)
    return res


def k2_layout(args, kw) -> int:
    """The K2 instantiation a call runs (csrc/shade.cu shade_layout: 1
    configs 3/4, 2 config 2, 0 generic)."""
    import ctypes

    from bibim_tpu_torch import _build
    from bibim_tpu_torch.ops import shading

    groups, _ = shading._groups(args[0], args[1], args[2], kw.get("mat_id"),
                                kw.get("tile_h", 8), kw.get("tile_w", 128))
    return _build.library().bb_shade_layout(ctypes.byref(groups))


def check_kernels(calls: dict) -> dict:
    """K1-K4 vs their plain versions on the 1080p frames' own inputs."""
    import torch

    from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain

    res = {"sort": check_sorts(calls["sort"]),
           # K1: the main raster pass of the first frame.
           "raster": check_raster(calls["raster"][0])}

    # K2: the first frame's sampled shade, its HDR output (no tail) and as
    # the frame calls it (the fused fp16 + tone-map tail), with its
    # normal-map toggle (off, as on the headline frame) and with the
    # normal map on; then the HDR output with a seeded [0, 1] shadow
    # visibility plane on light 0 (the shadows-without-IBL path).
    args, kw, _ = calls["shade"][0]
    hdr_kw = dict(kw, quantize_hdr=False, tonemap=False)
    errs = []
    for nm in (args[9], torch.ones_like(args[9])):
        a2 = args[:9] + (nm,) + args[10:]
        for kwx in (hdr_kw, kw):
            got = shade_sampled(*a2, **kwx)
            want = shade_sampled_plain(*a2, **kwx)
            torch.cuda.synchronize()
            errs.append(assert_shade_close(got, want, "K2"))
    gen = torch.Generator(device=args[1].device).manual_seed(SEED)
    vis = torch.rand(args[1].shape, generator=gen, device=args[1].device)
    kw_vis = dict(hdr_kw, vis_plane=vis, vis_light=0)
    got = shade_sampled(*args, **kw_vis)
    want = shade_sampled_plain(*args, **kw_vis)
    torch.cuda.synchronize()
    vis_err = assert_shade_close(got, want, "K2 with visibility")
    if torch.equal(got[0], shade_sampled(*args, **hdr_kw)[0]):
        raise AssertionError("K2: the visibility plane changed nothing")
    out = shade_sampled(*args, **kw)
    # 25-tap block rows × 3 channels and 4-tap quads × 7 channels.
    res["shade"] = dict(max_abs_err=max(errs + [vis_err]),
                        vis_max_abs_err=vis_err,
                        pixels=int(args[1].numel()), library_ms=None,
                        **shade_bound(args, kw, out, 25 * 3 + 4 * 7),
                        **shade_times(shade_sampled, shade_sampled_plain,
                                      args, kw, hdr_kw),
                        vis_ms=cuda_ms(lambda: shade_sampled(*args,
                                                             **kw_vis)),
                        vis_plain_ms=cuda_ms(
                            lambda: shade_sampled_plain(*args, **kw_vis)),
                        tails_equal=check_tails(calls, "1080p"))

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
    # K5 on the frame's inputs (IBL ambient, shadow visibility): its HDR
    # output (no quantize, no tonemap), and with fp16 + tone map on, as
    # the frame calls it.
    args, kw, _ = calls["shade_gbuffer"][0]
    hdr_kw = dict(kw, quantize=False, tonemap=False)
    got = shade_tonemap(*args, **hdr_kw)
    want = shade_tonemap_plain(*args, **hdr_kw)
    torch.cuda.synchronize()
    errs = [assert_shade_close(got, want, "K5", rel=True)]
    kw_tm = dict(kw, quantize=True, tonemap=True)
    got = shade_tonemap(*args, **kw_tm)
    want = shade_tonemap_plain(*args, **kw_tm)
    torch.cuda.synchronize()
    errs.append(assert_shade_close(got, want, "K5 quantize+tonemap"))
    res["shade_gbuffer"] = dict(
        max_abs_err=max(errs), pixels=int(args[3].numel()),
        library_ms=None, **shade_bound(args, kw, shade_tonemap(*args, **kw),
                                       0, sampled=False),
        vis=kw.get("vis_plane") is not None,
        ambient=kw.get("ambient") is not None,
        **shade_times(shade_tonemap, shade_tonemap_plain, args, kw, hdr_kw),
        tails_equal=check_tails(calls, "config-5"))

    # K6 and K7: bit-equal to their plain versions.
    res["sample_block"] = check_sampler(
        calls["sample_block"][0], tq.sample_table_block_kernel,
        tq.sample_table_block, "sample_block", 25)
    res["sample_small"] = check_sampler(
        calls["sample_small"][0], tq.sample_rows_small,
        tq.sample_rows_small_plain, "sample_small", 4)
    return res


SAMPLER_TAPS = {"sample_block": 25, "sample_small": 4,
                "sample_mip_block": 8}


def sampler_bytes(args, out) -> int:
    """Bytes a sampler call (K6, K7, K8) must move: every pixel's inputs
    (uv and the material ids; K7: its row index and fractions), the
    distinct table rows the pixels read, the output planes."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq

    if isinstance(args[0], torch.Tensor):  # K7: (quads, idx, tx, ty, ..)
        idx = args[1]
        return rows_bytes(args[0], idx) + 12 * idx.numel() \
            + tensor_bytes(out)
    if isinstance(args[0], tq.BlockTable):  # K6: (table, u, v)
        table, u, v = args[:3]
        mat_id, tile = None, (8, 128)
    else:  # K8: (table, mat_id, u, v, tile_h, tile_w)
        table, mat_id, u, v = args[:4]
        tile = tuple(args[4:6]) or (8, 128)
    n_planes = 2 + (mat_id is not None)
    return (tables_bytes((table,), u, v, mat_id, *tile)
            + 4 * n_planes * u.numel() + tensor_bytes(out))


def check_sampler(call, kern, plain, name: str, taps: int) -> dict:
    """A sampler kernel (K6, K7, K8) on one captured call: every slot
    plane bit-equal to its plain version; both timed. ``taps``: live taps
    per pixel and channel."""
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
    ops = plane.numel() * len(want) * taps * SAMPLE_TAP_OPS
    return dict(max_abs_err=0.0, pixels=int(plane.numel()),
                table=list(table.shape), slots=len(want), library_ms=None,
                whole_tensor_bytes=tensor_bytes(args, kw, got),
                **bound(sampler_bytes(args, got), ops),
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
    sort_keys.device_launches = 0
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
    print(k3_device_line("config-5 main path:"))
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
    args, kw, out = calls["shade"][0]
    # Mip-block groups: 8 live taps × 3 channels; quads 4 × 7.
    res["shade"] = dict(
        max_abs_err=0.0, calls=len(calls["shade"]),
        pixels=int(args[1].numel()), library_ms=None,
        **shade_bound(args, kw, out, 8 * 3 + 4 * 7),
        groups=[type(t).__name__ for t in args[0]],
        **shade_times(shade_sampled, shade_sampled_plain, args, kw,
                      dict(kw, quantize_hdr=False, tonemap=False)),
        tails_equal=check_tails(calls, "config-2"))
    for call in calls["sample_mip_block"][1:]:
        check_sampler(call, tq.sample_mip_block_kernel, tq.sample_mip_block,
                      "K8", 8)
    res["sample_mip_block"] = check_sampler(
        calls["sample_mip_block"][0], tq.sample_mip_block_kernel,
        tq.sample_mip_block, "K8", 8)
    res["sample_small"] = check_sampler(
        calls["sample_small"][0], tq.sample_rows_small,
        tq.sample_rows_small_plain, "K7 routed", 4)
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
    sort_keys.device_launches = 0
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
    print(k3_device_line("config-2 main path:"))
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


def standin_materials(dev):
    """Seeded stand-ins of the pbr maps, bound as the headline binds them:
    2048² metallic / roughness / ao as one block table, 16² albedo /
    normal / height as one quad table."""
    import numpy as np

    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.pipeline import BLOCK_TABLE_THRESHOLD

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
    return mats


def c4_view(label_yaw_dx, proj, dev):
    """(view block, host view matrix) of a config-4 view: the bench camera
    at (8, 6, -14), turned by ``yaw`` and moved ``dx`` along x."""
    import numpy as np
    import torch

    from bibim_tpu_torch.pipeline import ViewBlock
    from bibim_tpu_torch.scene.shaderball import instanced_camera

    _, yaw, dx = label_yaw_dx
    cam = instanced_camera()
    cam.yaw = yaw
    cam.pos = (cam.pos + np.float32([dx, 0.0, 0.0])).astype(np.float32)
    view = cam.get_view_matrix()
    return ViewBlock(
        view=torch.as_tensor(view, device=dev), proj=proj,
        view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(0, dtype=torch.int32,
                                       device=dev)), view


def c4_fine_vs_default(default, fine, differ) -> str:
    """A fine-bin frame against the default frame of its view. A fine bin
    (16 px wide) holds a subset of the candidates its coarse tile holds,
    so the two frames may differ only at pixels where the default winner
    is (a) tied on the masked depth key by the fine winner, which the
    dense passes resolve by fine-bin window position, not draw order (the
    reference's fine_bins multi-pass knife-edge, bibim_tpu/ops/fused.py
    raster_fused_pallas), or (b) a triangle whose bounding box misses the
    pixel: a near-degenerate sliver whose three edge functions round to
    >= 0 along its line, outside the triangle. The coarse tile admits such
    a candidate wherever the line crosses it; the fine bin does not. Both
    follow from the reference's coverage test and binning. Everywhere
    else the final depth keys and winners must be equal, and no fine key
    may be nearer than the default's. ``differ``: the image pixels that
    differ from the default frame."""
    import torch

    from bibim_tpu_torch.ops.geometry import assemble_scene_planar
    from bibim_tpu_torch.ops.raster import triangle_setup_planar
    from bibim_tpu_torch.pipeline import KERNELS
    from bibim_tpu_torch.pipeline.framegraph import (
        _assemble_and_raster,
        _untile,
    )

    (_, data, vb, s_d), (_, _, _, s_f) = default, fine
    px_d, zk_d, _, _ = _assemble_and_raster(data, vb, s_d, KERNELS)
    px_f, zk_f, _, _ = _assemble_and_raster(data, vb, s_f, KERNELS)
    if bool((zk_f > zk_d).any()):
        raise AssertionError("config-4 fine bins: a final depth key is "
                             "nearer than the default frame's")
    psoup = assemble_scene_planar(data.batches, vb.view, vb.proj,
                                  s_d.batch_material_ids)
    bbox = triangle_setup_planar(psoup.clip, s_d.width, s_d.height).bbox
    tri = _untile(px_d.tri_id, s_d).long()
    ys, xs = torch.meshgrid(
        torch.arange(s_d.height, device=tri.device),
        torch.arange(s_d.width, device=tri.device), indexing="ij")
    t = tri.clamp(min=0)
    outside = (tri >= 0) & ((xs < bbox[0][t]) | (ys < bbox[1][t])
                            | (xs > bbox[2][t]) | (ys > bbox[3][t]))
    tie = _untile(zk_d == zk_f, s_d)
    moved = _untile((zk_d != zk_f) | (px_d.tri_id != px_f.tri_id), s_d)
    if bool((moved & ~(tie | outside)).any()):
        raise AssertionError("config-4 fine bins: a winner differs from the "
                             "default frame's with neither a key tie nor "
                             "a pixel outside the default winner's bbox")
    if bool((differ & ~moved).any()):
        raise AssertionError("config-4 fine bins: a pixel differs from the "
                             "default frame where the winner is the same")
    return (f"vs the default frame {int(differ.sum())} pixels differ; "
            f"winners differ at {int((moved & tie).sum())} masked-key ties "
            f"and {int((moved & ~tie).sum())} pixels outside the default "
            "winner's bbox")


def run_config4(dev, smi: str, name: str):
    """The instanced path: per view host culling and the autotune of each
    raster mode, the kernel phases, then the counted frames."""
    import dataclasses

    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops.shading import shade_sampled
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import (
        KERNELS,
        PLAIN,
        FrameParams,
        RenderSettings,
        render_frame,
    )
    from bibim_tpu_torch.pipeline.autotune import (
        autotune_settings,
        dense_cap_candidates,
    )
    from bibim_tpu_torch.scene.culling import visible_instances
    from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    t0 = time.perf_counter()
    # No device argument: ShaderBallScene builds on the card.
    scene = ShaderBallScene(num_instances=C4_INSTANCES,
                            ball_mesh=generate_uv_sphere_mesh(100.0, 100,
                                                              51))
    built_on = scene.scene_data().batches[0].positions.device
    if built_on.type != "cuda":
        raise AssertionError(f"ShaderBallScene() built on {built_on}")
    mats = standin_materials(dev)
    proj_host = m3.perspective(60.0, WIDTH / HEIGHT, 0.1, 1000.0).numpy()
    proj = torch.as_tensor(proj_host, device=dev)
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(1, dtype=torch.int32, device=dev),
        exposure=torch.tensor(1.0, dtype=torch.float32, device=dev))
    base = RenderSettings(width=WIDTH, height=HEIGHT, outputs="image+diag",
                          show_gizmo=False, show_lights=False,
                          pair_sampling=0)
    full = scene.scene_data()
    t_all = sum(int(b.positions.shape[0]) // 3 * int(b.model.shape[0])
                for b in full.batches)
    print(f"config-4 frame: {WIDTH}x{HEIGHT}, {C4_INSTANCES} instances of "
          f"the stand-in ball, {t_all} triangles before culling, no light "
          f"spheres, no gizmo; scene built in "
          f"{time.perf_counter() - t0:.1f} s")

    frames = []  # (label, data, view block, settings)
    for view_def in C4_VIEWS:
        vb, view_host = c4_view(view_def, proj, dev)
        t0 = time.perf_counter()
        data = scene.culled_scene_data(view_host, proj_host)
        cull_ms = (time.perf_counter() - t0) * 1e3
        vp = proj_host @ view_host
        n_vis = int(visible_instances(scene.host_instances[0], vp).sum())
        bucket = int(data.batches[0].model.shape[0])
        tris = sum(int(b.positions.shape[0]) // 3 * int(b.model.shape[0])
                   for b in data.batches)
        print(f"config-4 view {view_def[0]}: culled on the host in "
              f"{cull_ms:.2f} ms: {n_vis} of {C4_INSTANCES} instances "
              f"visible, bucket {bucket}, {tris} triangles")
        for mode, extra in C4_MODES:
            t0 = time.perf_counter()
            s, probe = autotune_settings(
                data, vb, dataclasses.replace(base, **extra),
                margin=C4_MARGIN)
            tune_ms = (time.perf_counter() - t0) * 1e3
            cands = dense_cap_candidates(s, probe, margin=C4_MARGIN)
            picks = None
            if len(cands) > 1:
                s, results = pick_dense_cap(cands, data, vb, fp, mats)
                picks = [{"dense_tile_cap": sx.dense_tile_cap,
                          "device_ms": ms} for ms, sx in results]
            derived = {k: getattr(s, k) for k in (
                "max_candidates", "raster_passes", "merged_coverage",
                "dense_tile_cap", "raster_tile_cap", "live_tile_cap",
                "span_cap", "span_mid_cap", "overflow_cap", "pair_budget",
                "early_z", "fine_bins")}
            print(f"config-4 view {view_def[0]}, {mode}: autotune "
                  f"{tune_ms:.0f} ms; probe " + json.dumps(probe._asdict())
                  + "; derived " + json.dumps(derived)
                  + (f"; dense_tile_cap picked from {json.dumps(picks)}"
                     if picks else ""))
            if s.raster_passes < 2:
                raise AssertionError(f"config-4 {mode}: a single raster "
                                     "pass was derived")
            frames.append((f"{view_def[0]}, {mode}", data, vb, s))

    # Kernel phases on the frames' own inputs.
    calls: dict = {}
    per_frame = []
    for label, data, vb, s in frames:
        before = {k: len(v) for k, v in calls.items()}
        render_frame(data, vb, fp, mats, None, s,
                     kernels=capture_kernels(KERNELS, calls))
        per_frame.append({k: len(v) - before.get(k, 0)
                          for k, v in calls.items()})
    torch.cuda.synchronize()
    n_modes = len(C4_MODES)
    first = calls["raster"][:per_frame[0]["raster"]]
    kres = {
        "raster": check_raster(first[0], "raster", first[1:]),
        # Every sort of the nine frames: int32 packed keys, and on the
        # 64-instance view's early-z frame int64 keys.
        "sort": check_sorts(calls["sort"]),
        "raster_earlyz": check_raster(calls["raster_earlyz"][0],
                                      "raster_earlyz",
                                      calls["raster_earlyz"][1:]),
        "raster_fine": check_raster(calls["raster_fine"][0], "raster_fine",
                                    calls["raster_fine"][1:]),
    }
    args, kw, _ = calls["shade"][0]
    got = shade_sampled(*args, **kw)
    want = PLAIN.shade(*args, **kw)
    torch.cuda.synchronize()
    err = assert_shade_close(got, want, "K2 (config 4)")
    kres["shade"] = dict(
        max_abs_err=err, pixels=int(args[1].numel()), library_ms=None,
        **shade_bound(args, kw, got, 25 * 3 + 4 * 7),
        **shade_times(shade_sampled, PLAIN.shade, args, kw,
                      dict(kw, quantize_hdr=False, tonemap=False)),
        tails_equal=check_tails(calls, "config-4"))
    # K9's skipped-chunk share per view and over every captured call (all
    # passes).
    ez = iter(calls["raster_earlyz"])
    total = [0, 0]
    for (label, data, vb, s), n in zip(frames, per_frame):
        view = [0, 0]
        for _ in range(n.get("raster_earlyz", 0)):
            a, k, _ = next(ez)
            st = torch.zeros(2, dtype=torch.int64, device=dev)
            fused.raster_tiles_earlyz(*a, **k, stats=st)
            view = [x + y for x, y in zip(view, st.tolist())]
        if s.early_z:
            total = [x + y for x, y in zip(total, view)]
            print(f"config-4 K9 early-z, {label}: {view[1] - view[0]} of "
                  f"{view[1]} window chunks skipped by the break over "
                  f"{n['raster_earlyz']} launches")
    # K1 per launch of each default frame: does a pass's time follow its
    # total work or its longest window?
    k1 = iter(calls["raster"])
    for (label, _, _, s), n in zip(frames, per_frame):
        for p in range(n.get("raster", 0)):
            a, k, o = next(k1)
            if s.early_z or s.fine_bins:
                continue
            row = k1_launch(a, k)
            row["kernel_ms"] = row["kernel_ms_by_cluster"][row["cluster"]]
            row.update(raster_bound("raster", a, o))
            print(f"config-4 K1 launch, {label}, pass {p}: "
                  + json.dumps(row))
    kres["raster_earlyz"]["all_calls_skipped_chunk_share"] = (
        1.0 - total[0] / total[1])
    print(f"config-4 K9 early-z: {total[1] - total[0]} of {total[1]} window "
          f"chunks skipped by the break "
          f"({kres['raster_earlyz']['all_calls_skipped_chunk_share']:.4f})")
    for k, v in kres.items():
        print(f"kernel {k} (config 4): " + json.dumps(v))
    del calls

    # Main path: counters to 0, the nine frames through render_frame.
    counters = (fused.raster_tiles, sort_keys, shade_sampled,
                fused.raster_tiles_earlyz, fused.raster_tiles_fine)
    for fn in counters:
        fn.launches = 0
    sort_keys.device_launches = 0
    cover: list = []

    def cov(kern):
        def run(*args, **kw):
            out = kern(*args, **kw)
            if not cover:
                cover.append(out[-1][args[-1].index("idf")] >= 0.5)
            return out
        return run

    counted = KERNELS._replace(raster=cov(KERNELS.raster),
                               raster_earlyz=cov(KERNELS.raster_earlyz),
                               raster_fine=cov(KERNELS.raster_fine))
    outs = []
    for label, data, vb, s in frames:
        cover.clear()
        out = render_frame(data, vb, fp, mats, None, s, kernels=counted)
        outs.append((out, cover[0]))
    torch.cuda.synchronize()
    launches = {"raster": fused.raster_tiles.launches,
                "sort": sort_keys.launches,
                "shade": shade_sampled.launches,
                "raster_earlyz": fused.raster_tiles_earlyz.launches,
                "raster_fine": fused.raster_tiles_fine.launches}
    print("config-4 main-path launches: " + json.dumps(launches))
    print(k3_device_line("config-4 main path:"))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "config-4 frames")

    frame_ms = []
    for label, data, vb, s in frames:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_frame(data, vb, fp, mats, None, s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        frame_ms.append(statistics.median(times))
    for v in range(len(C4_VIEWS)):
        ref_default = None
        for m in range(n_modes):
            i = v * n_modes + m
            (out, cv), (label, data, vb, s) = outs[i], frames[i]
            ref = render_frame(data, vb, fp, mats, None, s,
                               kernels=PLAIN)["image"]
            if m == 0:
                ref_default = ref
            summary = check_frame(i, out, cv, ref, (HEIGHT, WIDTH, 3),
                                  "config-4")
            differ = (out["image"] != ref_default).any(dim=-1)
            if C4_MODES[m][0] == "fine_bins":
                summary += "; " + c4_fine_vs_default(
                    frames[v * n_modes], frames[i], differ)
            elif bool(differ.any()):
                raise AssertionError(f"config-4 frame {i} ({label}) differs "
                                     "from the all-plain default render")
            print(f"config-4 frame {i}: {label}, {s.raster_passes} passes, "
                  f"host median {frame_ms[i]:.2f} ms ({name}, {smi}), "
                  + summary)
    print(f"config-4 frame time median: {statistics.median(frame_ms):.2f} "
          f"ms (host clock around render_frame + synchronize, {name}, "
          f"{smi})")
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
        import dataclasses

        from bibim_tpu_torch import _build
        from bibim_tpu_torch.ops import fused
        from bibim_tpu_torch.ops.shading import shade_sampled
        from bibim_tpu_torch.ops.sort import sort_keys
        from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame
        from bibim_tpu_torch.pipeline.autotune import (
            derive_settings,
            probe_frame_caps,
        )
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
    usage = ptxas_usage(_build.build_log)
    print("ptxas usage: " + json.dumps(usage))
    shading = {k: v for k, v in usage.items()
               if k.startswith(("shade_kernel", "gbuffer_shade_kernel"))}
    if len(shading) < 4 or any(v.get("stack", 1) or v.get("spill_stores", 1)
                               or v.get("spill_loads", 1)
                               for v in shading.values()):
        raise AssertionError("K2 / K5 instantiations must have a 0-byte "
                             "stack frame and no spills: "
                             + json.dumps(shading))

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
    del calls

    # The group-window frame: group_pair_cap from the port's probe of the
    # first view (derive_settings' rule), the other capacities as above.
    vb0 = view_block(YAWS[0], proj, dev)
    probe = probe_frame_caps(scene, vb0, settings)
    gw_cap = derive_settings(dataclasses.replace(
        settings, group_pair_cap=settings.max_candidates),
        probe).group_pair_cap
    if gw_cap is None:
        raise AssertionError("no group window derived for the 1080p frame")
    settings_gw = dataclasses.replace(settings, group_pair_cap=gw_cap)
    print(f"group window: probe group_win {probe.group_win} (max "
          f"candidates {probe.max_candidates}, bin tiles "
          f"{probe.bin_tiles}) → group_pair_cap {gw_cap}")
    calls = {}
    render_frame(scene, vb0, fp, mats, overlay, settings_gw,
                 kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres["raster_gw"] = check_raster(calls["raster_gw"][0], "raster_gw")
    del calls
    for k, v in kres.items():
        print(f"kernel {k}: " + json.dumps(v))

    # Main path: counters to 0, the four frames through render_frame; then
    # counters to 0 again and the group-window frame in its own window.
    frames = [(f"yaw {y}", view_block(y, proj, dev), settings) for y in YAWS]
    frames.append((f"yaw {YAWS[0]}, group window", vb0, settings_gw))
    counters = {"raster": fused.raster_tiles, "shade": shade_sampled,
                "sort": sort_keys, "overlay": fused.overlay_tiles,
                "raster_gw": fused.raster_tiles_gw}
    cover: list = []

    def cov(kern):
        def run(*args, **kw):
            out = kern(*args, **kw)
            cover.append(out[-1][args[-1].index("idf")] >= 0.5)
            return out
        return run

    counted = KERNELS._replace(raster=cov(KERNELS.raster),
                               raster_gw=cov(KERNELS.raster_gw))
    outs, frame_ms, windows = [], [], []
    for window in (frames[:len(YAWS)], frames[len(YAWS):]):
        for fn in counters.values():
            fn.launches = 0
        sort_keys.device_launches = 0
        for _, vb, s in window:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_frame(scene, vb, fp, mats, overlay, s,
                               kernels=counted)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append((out, cover[-1]))
        windows.append({k: fn.launches for k, fn in counters.items()})
        print(k3_device_line(f"1080p main path ({len(window)} frames):"))
    launches = dict(windows[0], raster_gw=windows[1]["raster_gw"])
    print(f"main-path launches ({len(YAWS)} frames): "
          + json.dumps(windows[0]))
    print("group-window frame launches (1 frame): " + json.dumps(windows[1]))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the frame")

    for i, ((out, cov_i), (label, vb, s)) in enumerate(zip(outs, frames)):
        ref = render_frame(scene, vb, fp, mats, overlay, s,
                           kernels=PLAIN)["image"]
        summary = check_frame(i, out, cov_i, ref, (HEIGHT, WIDTH, 3),
                              "1080p")
        print(f"frame {i}: {label}, {frame_ms[i]:.2f} ms, " + summary)
    if not torch.equal(outs[-1][0]["image"], outs[0][0]["image"]):
        raise AssertionError("the group-window frame differs from the "
                             "default frame of its yaw")
    print(f"frame time median: {statistics.median(frame_ms[:len(YAWS)]):.2f}"
          f" ms (host clock around render_frame + synchronize, {name}, "
          f"{smi}); group-window frame {frame_ms[-1]:.2f} ms")
    del outs

    kres5, launches5 = run_config5(dev, smi, name)
    kres2, launches2 = run_config2(dev, smi, name)
    kres4, launches4 = run_config4(dev, smi, name)

    # One row per kernel and path: K1-K4 on the 1080p path's 4 frames, K10
    # on its group-window frame, every kernel the config-5 path runs (K1
    # twice: main and shadow pass), every kernel of the config-2 path (K2
    # with the mip groups, K8, K7 routed), then the config-4 path (K1, K3,
    # K2, K9, K11). ``frames``: the main-path frames its launches count.
    n2, n4 = len(C2_CAMERA_Z) + len(C2_VIEWS), len(C4_VIEWS) * len(C4_MODES)
    rows = [(k, KERNEL_INFO[k][0] + ", 1080p", kres[k], launches[k],
             1 if k == "raster_gw" else len(YAWS)) for k in kres]
    rows += [(k, KERNEL_INFO[k][0] + ", config-5 4K", kres5[k],
              launches5[k], len(C5_YAWS)) for k in kres5 if k in KERNEL_INFO]
    rows.append(("raster", KERNEL_INFO["raster"][0]
                 + ", config-5 shadow pass", kres5["raster_shadow_pass"],
                 launches5["raster_shadow_pass"], len(C5_YAWS)))
    rows += [(k, KERNEL_INFO[k][0] + ", config-2 720p cubes", kres2[k],
              launches2[k], n2) for k in kres2]
    rows += [(k, KERNEL_INFO[k][0] + ", config-4 1080p x64", kres4[k],
              launches4[k], n4) for k in kres4]
    kernels = []
    for k, label, r, n, frames in rows:
        _, src, repl = KERNEL_INFO[k]
        kernels.append({"name": label, "route": "cuda", "source": src,
                        "replaces": repl, "launches": n, "frames": frames,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    if len({KERNEL_INFO[k][0] for k, *_ in rows}) != 11:
        raise AssertionError("the kernels line does not list all eleven "
                             "kernels")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
