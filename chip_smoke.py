#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bibim_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the eleven CUDA kernels from ``bibim_tpu_torch/csrc`` (into
   ``build/``, one nvcc per source in parallel) and prints the build time
   and, per kernel instantiation, ptxas's registers, stack frame and spill
   bytes (every K2, K4, K5, K8, K9, K10 and K11 instantiation must have a
   0-byte stack frame and no spills);
2. the 512×512 flat-shaded frame (BASELINE config 1: GizmoScene on a
   coloured 360-triangle stand-in for gizmo.obj, the gizmo camera, no
   lights, bench.py's default capacities): K1 and K3 against their plain
   versions, then the frame with the counters reset just before;
3. builds the frames from repository-only inputs: the ShaderBall scene's
   structure (100× ground plane at y=-10, the three ShaderBall lights, the
   default camera) with a ~10k-triangle UV sphere at the ball's instance
   transform standing in for ShaderBall.fbx, and seeded random materials
   bound like the headline frame — 2048² metallic / roughness / ao as one
   block table, 16² albedo / normal / height as one quad table; light
   spheres on, gizmo off (gizmo.obj is not in the repository); configs
   3, 4 and 5 take their capacities from ``autotune_settings(...,
   pair_sampling=2, margin=1.05, materials=, overlay=)`` per view, as
   bench.py does, and print the probe's escape and covered tiles and the
   derived pair level and route caps;
4. the 1920×1080 deferred PBR path (BASELINE config 3): checks K1 raster,
   K2 sampled shade (with and without a shadow visibility plane), K3 pair
   sort and K4 overlay against their plain PyTorch versions on the inputs
   the frame itself produces and times both (median of CUDA-event
   timings; K2 and K5 also kernel-only by ``torch.profiler``, with and
   without their fused fp16 + tone-map tail, which must equal the frame's
   torch tail, ``torch.equal``, on every captured call of every path);
   sizes ``group_pair_cap`` from the port's capacity probe and
   checks K10 (group window) on that frame, at every cluster size, and
   prints its launch (slots, group, the group windows' lengths, prefix
   and dropped rows, kernel ms at every cluster size, the bound, K1's
   kernel ms on the same windows); prints, for the light-sphere call
   with the most live slots and for the HUD frame's call, K4's launch
   (slots, live slots, overflow rows, window lengths, the cluster size
   and cluster count its wrapper picks, kernel ms at every cluster size
   and on a grid of one cluster a slot, the bound, K1's kernel ms on the
   same tiles, windows and initial keys, and the whole
   ``composite_overlay`` call's device ms and launches); renders 4
   frames at 4 camera yaws through ``render_frame`` with launch counters
   reset just before, then the group-window frame with the counters
   reset again (it must equal the default frame of its yaw), then the
   HUD frame (the first yaw with the app's stats line burned in,
   ``show_hud``) with the counters reset again: it must be bit-equal to
   the HUD-off frame outside the text rows, its glyph pixels white;
5. the 3840×2160 shadows + IBL path (BASELINE config 5: shadow map of the
   ball at 1024², analytic IBL from the procedural sky): checks K1 (the
   4K main pass and the 1024² shadow pass), K3 (every sort), K4 (with
   its launch line), K5
   G-buffer shade, K6 block-table and K7 small-table samplers against
   their plain versions on that path's inputs and times both; renders 3
   frames with the counters reset just before, the shadow pass's K1
   launches counted apart;
6. pair-rate sampling: a routed close-up of the config-3 stand-in (its
   ground plane from 1 unit above, the block maps magnified, so the
   probe keeps pair level 2 on), a 1080p ``pair_lossy`` frame (K2 at
   level 2), a config-5 ``pair_lossy`` frame (K6 at level 2 on the
   G-buffer path) and a config-5 ``pair_visibility`` frame: every K2 and
   K6 launch at a pair level against its plain version (K6 bit-equal, K2
   within ``_assert_close``) and timed; the four frames with the counters
   reset just before (K2's and K6's pair launches counted apart), each
   against the all-plain render, the routed frame ``torch.equal`` to its
   pair-0 frame and profiled against it (device ms, launches);
7. the 1280×720 textured-cube path (BASELINE config 2: two cubes,
   trilinear mip-block albedos from seeded 1024² / 2048² stand-ins, two
   materials routed by batch): renders the bench frame at three camera
   positions and the ALBEDO and MRHA G-buffer views of the first; checks
   K1, K3, K2 with the mip-block and routed small groups, K8 mip-block and
   K7 (routed rows) against their plain versions on that path's inputs
   (K2 and K8 bit-equal; K8 also on LOD knife-edge inputs,
   :func:`mip_rho_stress`) and times both, and prints K8's launch
   (wrapper, kernel and torch-geometry ms, the bound); renders the five
   frames again
   with the counters reset just before, and prints per view a histogram of
   the selected mip level and the share of pixels blending two levels;
8. the 1920×1080 instanced path (BASELINE config 4: 64 instances of the
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
   their bound, and every K9 launch (each pass of each early-z frame) and
   K11 launch (pass 0 of each fine-bin frame): slots, window lengths
   (K11: also its subtile windows), overflow entries, K9's skipped-chunk
   share, the kernel ms at every split (K9's cluster sizes, K11's warps a
   subtile), the bound, and K1's kernel ms on the same windows; renders
   the nine frames with the counters reset just before; the default and
   early-z frames must equal the all-plain render of the default
   settings; a fine-bin frame may differ from them only at masked-key
   ties and where the default winner's bounding box misses the pixel
   (``c4_fine_vs_default``);
9. the newest paths (:func:`run_new_paths`): on the config-3 stand-in at
   1920×1080 the forward frame (settings autotuned as config 3's) beside
   the deferred one, forward and deferred shadows + analytic IBL, 2 and 4
   anisotropic taps, the stand-in rebuilt from hand-built shared-vertex
   batches (the (T, 3) path; ``torch.equal`` to the planar frame) with
   and without shadows and with the TBN view; the config-2 cubes at
   1280×720 at 2 taps and on per-material MaterialTextures; a MeshScene
   frame of a torus OBJ written to a temporary directory. Every K1, K2,
   K5, K6, K7 and K8 launch of those frames against its plain version
   (one of each timed, with its kernel-only time), the frames with the
   counters reset just before, each frame's device ms and launches (by
   ``torch.profiler``) beside its twin's;
10. the host (:func:`run_host`), on a stand-in resource root
   (:func:`write_standin_resources`: 2048² maps, the stand-in ball as a
   binary ShaderBall.fbx, gizmo.obj) at 1920×1080 on the ShaderBall scene,
   deferred: the CLI (``host.app.main``) frames — default, forward, HUD,
   shadows + IBL, a torus MeshScene — each PNG equal to a direct
   render_frame, then its ``--no-write`` loop's ms/frame; a ~60-frame
   Session script at readback depth 2 (WASD, a drag, a material switch,
   exposure / TBN / HUD toggles, a resize to 1280×720, the gizmo and cube
   scenes) with the counters reset just before it, four of its frames
   equal to direct renders at the session's pose and settings, its first
   frame's K1-K4 against their plain versions, every retune's caps; the
   host syncs of one Session.render (torch's sync debug mode) and 50
   frames at readback depth 1 and 2 (host ms, device ms, busy share, each
   image equal to its frame's output); the live viewer for a few seconds
   (/frame.jpg, a W key event, /stats, served fps, stop());
11. the sharded frame (:func:`run_sharded`): the config-3 stand-in at
   1920×1080 from the host phase's first pose on 4 in-process bands (all
   on cuda:0 with one card, spread over the cards with more) through a
   ``ShardedRenderer`` tuned by ``autotune_settings_sharded(pair_sampling=2,
   margin=1.05, materials=, overlay=)``, its frames with the counters
   reset just before; every band's K1, K3, K2 and K4 launch of the first
   frame against its plain version; the band height, each band's K1
   slots, pairs and covered tiles, the band caps beside the frame caps;
   the frame within the golden bound of ``render_frame`` on one card at
   the same settings, drop-free, and its device ms, host ms and launches
   beside that frame's; the sharded dry run
   (``parallel.dryrun.dryrun_multichip(4)`` on a stand-in resource root:
   retunes 1 then 2, its K1 shadow passes and every band's K5, K6 and K7
   against their plain versions); the frame on 2 ranks spawned with
   ``torch.multiprocessing`` (NCCL with a card each when there are 2
   cards, else gloo with both on cuda:0), each rank's image
   ``torch.equal`` to the in-process 2-band frame, its wall ms;
12. checks, on every frame, zero capacity drops (shadow pass included),
   coverage, that the image is not background, and the frame against the
   all-plain render of the same frame at the golden-image bound;
13. prints the GPU's ``nvidia-smi`` name/power-limit line, one JSON line of
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
# Capacities: configs 3, 4 and 5 take them from autotune_settings at the
# bench's margin, each view its own (bench.py:196-199, :468-470, :555-565;
# validated: any overflow is reported in BinDiag and fails
# check_bin_diag), asking for pair sampling, which the escape-tile probe
# keeps or turns off.
MARGIN = 1.05
BASE3 = dict(pair_sampling=2)
# Explicit capacities of the same frames, which the GPU tools
# (tools/torch_profile.py, shade_variants.py, raster_variants.py) render
# so that their profiles stay comparable across changes.
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
BASE5 = dict(span_cap=32, pair_sampling=2)
C5_CAPS = dict(
    max_candidates=128, raster_passes=1, overflow_cap=64, span_cap=32,
    span_mid_cap=8192, pair_budget=262144, live_tile_cap=4096,
    raster_tile_cap=4096, overlay_candidates=384, overlay_overflow_cap=512,
    overlay_max_tiles=1024, shadow_size=1024, shadow_candidates=256,
    shadow_passes=1, shadow_tile_cap=1024,
)
# The derived settings each view prints.
DERIVED_KEYS = (
    "pair_sampling", "sample_route_caps", "max_candidates", "raster_passes",
    "live_tile_cap", "raster_tile_cap", "span_cap", "span_mid_cap",
    "overflow_cap", "pair_budget", "overlay_candidates", "overlay_max_tiles",
    "overlay_overflow_cap", "shadow_candidates", "shadow_passes",
    "shadow_tile_cap", "shadow_query_tile_cap")
# BASELINE config 1 (bench.py bench_gizmo): gizmo.obj flat-shaded at
# 512x512 from the gizmo camera, no lights, tone map off; a coloured
# stand-in for gizmo.obj (not in the repository).
C1_SIZE = 512
# The routed frame: the config-3 stand-in from 1 unit above its ground
# plane, looking down steeply, where the 2048² block maps are magnified
# (20 texels a unit, 20-45 pixels a texel) and most tiles sample
# bit-exactly at pair level 2, so the probe keeps routing on.
CLOSE_UP_POS, CLOSE_UP_PITCH = (0.0, -9.0, 0.0), -70.0
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
# light spheres, no gizmo, autotuned at the bench's margin with base
# pair_sampling=2 and the materials. Views: the bench camera (14 of 64
# instances in view: bucket 16), orbits to yaw -25 (28: bucket 32) and to
# yaw -45 (60: bucket 64, 640,002 triangles, so the early-z pair key has no
# room in 31 bits and sorts as int64 with a 16-bit depth bucket).
C4_INSTANCES = 64
C4_VIEWS = (("bench camera", 0.0, 0.0), ("yaw -25", -25.0, 0.0),
            ("yaw -45", -45.0, 0.0))
C4_MODES = (("default", {}), ("early_z", {"early_z": True}),
            ("fine_bins", {"fine_bins": True}))
C4_MARGIN = 1.05
# The viewer session's merged caps for the 64 balls (max_candidates,
# raster_passes: each cap the largest of its autotunes along the
# benchmark's orbit_row path), at which K1's tail is also timed.
C4_SESSION_CAPS = (1024, 88)
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
# Live taps per pixel and channel of each sampler: a block row's 25 taps
# hold 4 of non-zero weight (the kernels blend only those), a quad 4, a
# mip-block group 8 (two levels). K2's block groups: 3 block channels and
# 7 quad channels.
SAMPLER_TAPS = {"sample_block": 4, "sample_small": 4, "sample_mip_block": 8}
K2_BLOCK_TAP_CHANNELS = (SAMPLER_TAPS["sample_block"] * 3
                         + SAMPLER_TAPS["sample_small"] * 7)
KERNEL_INFO = {
    "raster": ("K1 raster", "bibim_tpu_torch/csrc/raster.cu",
               "bibim_tpu/ops/fused.py:670"),
    "shade": ("K2 sampled shade", "bibim_tpu_torch/csrc/shade.cu",
              "bibim_tpu/ops/shading_pallas.py:294"),
    "sort": ("K3 pair sort", "bibim_tpu_torch/csrc/sort.cu",
             "bibim_tpu/ops/sort_pallas.py:43"),
    "overlay": ("K4 overlay composite", "bibim_tpu_torch/csrc/raster.cu",
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
                  "bibim_tpu_torch/csrc/raster.cu",
                  "bibim_tpu/ops/fused.py:1085"),
    "raster_fine": ("K11 fine-subtile raster",
                    "bibim_tpu_torch/csrc/raster_fine.cu",
                    "bibim_tpu/ops/fused.py:905"),
    # K1's passes 1..P-1 (raster_fused_pallas's pass loop), one launch.
    "raster_tail": ("K1 raster", "bibim_tpu_torch/csrc/raster.cu",
                    "bibim_tpu/ops/fused.py:670"),
}


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# This run's ptxas usage per kernel instantiation (main fills it).
PTXAS: dict = {}


def ptxas_rows(pattern: str) -> dict:
    """The ptxas rows (registers, stack, spills) of the instantiations
    whose name matches ``pattern`` (a regular expression from its
    start)."""
    import re

    return {k: v for k, v in PTXAS.items() if re.match(pattern, k)}


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


def profile_window(fn, reps: int, match: str | None = None):
    """``key_averages()`` of ``reps`` calls of ``fn`` under
    ``torch.profiler`` (CPU and CUDA activity), after one warm-up, and the
    device microseconds of the events whose name contains ``match`` (all
    device events for None). On the H100 the profiler now and then
    records no device event for a window (seen in two smoke runs, and
    three windows in a row once): a window with none of them is profiled
    again, six times at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and (match is None or match in e.key))
        if us > 0:
            break
    return ka, us


def profiled_ms(fn, match: str, reps: int = 20):
    """Device milliseconds per ``fn`` call of the kernels whose name
    contains ``match`` under ``torch.profiler`` (their own run time, no
    gaps between launches), or None where the profiler recorded none."""
    _, us = profile_window(fn, reps, match)
    return us / 1e3 / reps if us > 0 else None


def device_ms(fn, reps: int = 3, match: str | None = None) -> float:
    """Device milliseconds per ``fn`` call, after one warm-up: the summed
    time of the device-side events (kernels, memcpy, memset) that ``reps``
    calls put on the card under ``torch.profiler``; with ``match``, only
    the kernels whose name contains it. Unlike CUDA events around a
    host-bound call, it does not count the gaps the host leaves."""
    _, us = profile_window(fn, reps, match)
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


def derive(scene, vb, base, mats, overlay, what: str):
    """``autotune_settings`` as bench.py calls it (margin 1.05, the
    material binding and the overlay resources), printed: the probe's
    escape and covered tiles and the derived capacities."""
    from bibim_tpu_torch.pipeline.autotune import autotune_settings

    t0 = time.perf_counter()
    s, probe = autotune_settings(scene, vb, base, margin=MARGIN,
                                 materials=mats, overlay=overlay)
    print(f"{what}: autotune {(time.perf_counter() - t0) * 1e3:.0f} ms; "
          f"probe escape_tiles {probe.escape_tiles} of covered_tiles "
          f"{probe.covered_tiles} ({probe.n_tiles} tiles); derived "
          + json.dumps({k: getattr(s, k) for k in DERIVED_KEYS}))
    return s


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
            kept = args
            if name == "overlay":
                # K4 writes its LDR planes in place: keep the input.
                kept = args[:9] + (args[9].clone(),) + args[10:]
            elif name == "raster_tail":
                # So does K1's tail, its keys and planes.
                kept = tail_inputs(args)
            out = fn(*args, **kw)
            calls.setdefault(name, []).append((kept, kw, out))
            return out
        return run

    return Kernels(*(wrap(n, f) for n, f in zip(Kernels._fields, kernels)))


class capture_composites:
    """Within the block, every ``ops.fused.composite_overlay`` call (the
    frame's light spheres and HUD) is recorded into ``calls`` as (args,
    kw) with its LDR input as it was before the call."""

    def __init__(self, calls: list):
        self.calls = calls

    def __enter__(self):
        from bibim_tpu_torch.ops import fused

        self.fn = fn = fused.composite_overlay

        def run(*args, **kw):
            ldr = args[2]
            keep = (tuple(c.clone() for c in ldr) if isinstance(ldr, tuple)
                    else ldr.clone())
            self.calls.append((args[:2] + (keep,) + args[3:], kw))
            return fn(*args, **kw)

        fused.composite_overlay = run
        return self

    def __exit__(self, *exc):
        from bibim_tpu_torch.ops import fused

        fused.composite_overlay = self.fn


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
        # A cleared key (zkey None) reads no plane.
        init = () if args[8] is None else args[8][ids.long()]
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
        # Winners by the plain scan of the live slots. The kernel writes
        # the three LDR channels of the pixels an overlay triangle wins
        # and reads no image pixel.
        px, py = fused._pixel_centres(ids, args[10], args[11], args[12])
        if isinstance(init, tuple):
            init = torch.zeros_like(px, dtype=torch.int32)
        _, best = fused._scan_plain(rec, big_ids, n_big, pair_tri, starts,
                                    cnt, init, px, py)
        hits = (best >= 0) & (rec[best.clamp(min=0).long(), fused._ID]
                              >= 0.5)
        chans = field_channels(("cr", "cg", "cb"))
        return int(nbytes + n_distinct(best) * chans * 4
                   + int(hits.sum()) * 3 * args[9].element_size())
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


def table_rows(table, u, v, mat_id, tile_h: int, tile_w: int, pair: int = 0,
               valid=None):
    """The row of material table ``table`` each pixel reads (its layout's
    footprint, as the samplers compute it; a block table at pair level
    ``pair``: its group's anchor row, one a group)."""
    from bibim_tpu_torch.ops import texture_quad as tq

    if isinstance(table, tq.BlockTable) and pair:
        return tq._block_taps(table, u, v, pair, valid, tile_w)[0]
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


def tables_bytes(tables, u, v, mat_id, tile_h, tile_w, mask=None,
                 pair: int = 0, valid=None) -> int:
    """Bytes of the distinct table rows the pixels of ``mask`` (default:
    all) read, over every table of a material binding (block tables at
    pair level ``pair``, anchored by ``valid``)."""
    total = 0
    for t in tables:
        rows = table_rows(t, u, v, mat_id, tile_h, tile_w, pair,
                          valid).reshape(-1)
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
    bound; K9-K11 bit-equal in every output, K10 at every cluster size.
    K9 runs with its chunk counter: the share of window chunks its break
    skipped."""
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
        want = plain(*args, **kw)
        # K10 also at every cluster size (the wrapper's pick first).
        splits = fused.CLUSTER_SIZES if name == "raster_gw" else ()
        for knob in [{}] + [{"cluster": c} for c in splits]:
            got = kern(*args, **kwk, **knob)
            torch.cuda.synchronize()
            if name != "raster" and not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name}: differs from its plain "
                                     f"version ({knob or 'its pick'})")
        if name != "raster":
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

    return dict(
        window_stats(args[6]), overflow=int(args[2][0]),
        cluster=fused.raster_cluster(int(args[4].shape[0]),
                                     kw.get("max_count")),
        kernel_ms_by_cluster={c: graph_ms(lambda: fused.raster_tiles(
            *args, **kw, cluster=c)) for c in fused.CLUSTER_SIZES})


def window_stats(counts) -> dict:
    """Slots, live slots (a window of at least one candidate) and the
    window lengths of one raster call (``counts`` read on the host)."""
    counts = counts.reshape(-1).cpu().float()
    live = counts[counts > 0]
    return dict(
        slots=int(counts.numel()),
        live_slots=int(live.numel()),
        window_max=int(counts.max()) if counts.numel() else 0,
        window_mean=float(counts.mean()) if counts.numel() else 0.0,
        live_window_mean=float(live.mean()) if live.numel() else 0.0)


def tail_inputs(args) -> tuple:
    """A K1 tail call's arguments with fresh copies of the keys and planes
    it merges into in place (args 5 and 6)."""
    return args[:5] + (args[5].clone(), args[6].clone()) + args[7:]


class capture_setups:
    """Within the block, the triangle setup of every
    ``ops.fused.raster_fused`` call, by the id of its record table (the
    first argument of the K1 calls it makes)."""

    def __init__(self, setups: dict):
        self.setups = setups

    def __enter__(self):
        from bibim_tpu_torch.ops import fused

        self.fn = fn = fused.raster_fused

        def run(rec, setup, *args, **kw):
            self.setups[id(rec)] = (rec, setup)
            return fn(rec, setup, *args, **kw)

        fused.raster_fused = run
        return self

    def __exit__(self, *exc):
        from bibim_tpu_torch.ops import fused

        fused.raster_fused = self.fn


def tail_bound(args, setup) -> dict:
    """:func:`bound` of one K1 tail call, counted as
    ``h100_bench/roofline/k1.py`` counts a raster pass: each tail row
    tested at the pixels of its triangle's bounding box inside its slot's
    tile (COVER_OPS) and each pixel a row of the tail won resolved
    (RESOLVE_OPS); bytes: each row's COVER_CH coverage floats, the record
    channels of each distinct winning triangle, the initial key at every
    pixel of a live slot, the key at each pixel the tail won and the
    planes at each such pixel whose winner is a triangle. Also the rows,
    live and empty slots and the longest tail."""
    import torch

    from bibim_tpu_torch.ops import fused

    rec, pair_tri, ids, starts, counts, zkey = args[:6]
    tiles_x, tile_h, tile_w = args[7:10]
    out_fields = args[10] if len(args) > 10 else fused._OUT_FIELDS
    live = counts > 0
    ids_l, st, cn = ids[live].long(), starts[live].long(), counts[live].long()
    rows = int(cn.sum())
    slot = torch.repeat_interleave(torch.arange(cn.numel(), device=cn.device),
                                   cn)
    first = torch.cumsum(cn, 0) - cn
    pos = torch.arange(rows, device=cn.device) - first[slot]
    tri = pair_tri[st[slot] + pos].long()
    bx0, by0, bx1, by1 = (b[tri.clamp(min=0)].long() for b in setup.bbox)
    x0 = (ids_l % tiles_x * tile_w)[slot]
    y0 = (ids_l // tiles_x * tile_h)[slot]
    box_px = (torch.clamp(torch.minimum(bx1, x0 + tile_w - 1)
                          - torch.maximum(bx0, x0) + 1, min=0)
              * torch.clamp(torch.minimum(by1, y0 + tile_h - 1)
                            - torch.maximum(by0, y0) + 1, min=0))
    px, py = fused._pixel_centres(ids_l.int(), tiles_x, tile_h, tile_w)
    _, best = fused._scan_plain(
        rec, torch.zeros((0,), dtype=torch.int32, device=rec.device),
        torch.zeros((1,), dtype=torch.int32, device=rec.device), pair_tri,
        st.int(), cn.int(), zkey[ids_l], px, py)
    won = best >= 0
    covered = won & (rec[best.clamp(min=0).long(), fused._ID] >= 0.5)
    winners = n_distinct(torch.where(covered, best, torch.full_like(best,
                                                                   -1)))
    nbytes = (rows * COVER_CH * 4
              + winners * field_channels(out_fields) * 4
              + cn.numel() * tile_h * tile_w * 4 + int(won.sum()) * 4
              + int(covered.sum()) * len(out_fields) * 4)
    ops = (int(box_px.sum()) * COVER_OPS
           + int(covered.sum()) * RESOLVE_OPS)
    return dict(bound(nbytes, ops), tail_rows=rows,
                live_slots=int(cn.numel()),
                empty_slots=int(counts.numel() - cn.numel()),
                longest=int(cn.max()) if cn.numel() else 0,
                won_px=int(won.sum()), box_px=int(box_px.sum()))


def check_raster_tail(calls, setups, repeats: int = 5) -> dict:
    """K1's tail on every captured call (arguments as before the call):
    keys and the id plane bit-equal to its plain version, the other
    planes within K1's 1e-3, and ``repeats`` launches on fresh copies of
    the inputs bit-equal to one another (the atomic merge does not depend
    on the order the parts finish). Then, on the first call, the wrapper
    ms (CUDA events), the kernel ms (:func:`graph_ms`; replays merge into
    the planes the first launch left, which gives the same winners and
    the same work), the plain ms and :func:`tail_bound`."""
    import torch

    from bibim_tpu_torch.ops import fused

    err = 0.0
    for args, kw, _ in calls:
        want = fused.raster_tiles_tail_plain(*tail_inputs(args), **kw)
        out_fields = args[10] if len(args) > 10 else fused._OUT_FIELDS
        idf = out_fields.index("idf")
        first = None
        for _ in range(repeats):
            got = fused.raster_tiles_tail(*tail_inputs(args), **kw)
            torch.cuda.synchronize()
            if not torch.equal(got[0], want[0]) or not torch.equal(
                    got[1][idf], want[1][idf]):
                raise AssertionError("K1 tail: zkey / tri_id differ from "
                                     "its plain version")
            err = max(err, float((got[1] - want[1]).abs().max()))
            if err > 1e-3:
                raise AssertionError(f"K1 tail planes differ by {err}")
            if first is None:
                first = got
            elif not (torch.equal(got[0], first[0])
                      and torch.equal(got[1], first[1])):
                raise AssertionError("K1 tail: repeated launches differ")
    args, kw, _ = calls[0]
    run = tail_inputs(args)
    return dict(max_abs_err=err, checked_calls=len(calls),
                repeats=repeats, planes=len(run[10]) if len(run) > 10
                else len(fused._OUT_FIELDS),
                ms=cuda_ms(lambda: fused.raster_tiles_tail(*run, **kw)),
                kernel_ms=graph_ms(lambda: fused.raster_tiles_tail(*run,
                                                                   **kw)),
                plain_ms=cuda_ms(lambda: fused.raster_tiles_tail_plain(
                    *tail_inputs(args), **kw), 2),
                library_ms=None,
                **tail_bound(args, setups[id(args[0])][1]))


def k1_reference_ms(args8, tiles, out_fields, max_count) -> dict:
    """K1's kernel ms on another kernel's candidate windows (``args8``:
    rec, big_ids, n_big, pair_tri, ids, starts, counts, init_zkey), at
    the cluster size its wrapper picks for ``max_count`` and at every
    size; a timing reference only, its output is not compared."""
    from bibim_tpu_torch.ops import fused

    by = {c: graph_ms(lambda: fused.raster_tiles(
        *args8, *tiles, out_fields, cluster=c))
        for c in fused.CLUSTER_SIZES}
    pick = fused.raster_cluster(int(args8[4].shape[0]), max_count)
    return dict(k1_cluster=pick, k1_kernel_ms=by[pick],
                k1_kernel_ms_by_cluster=by)


def k9_launch(args, kw, out) -> dict:
    """One K9 call as its launch sees it (:func:`window_stats`, the
    overflow entries, the share of window chunks its break skips), its
    kernel ms (:func:`graph_ms`) at the split the wrapper picks and at
    every split, its bound, and K1's kernel ms on the same ``ids,
    starts, counts, init_zkey`` (:func:`k1_reference_ms`)."""
    import torch

    from bibim_tpu_torch.ops import fused

    stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    fused.raster_tiles_earlyz(*args, **kw, stats=stats)
    scanned, present = stats.tolist()
    share = scanned / max(present, 1)
    row = dict(window_stats(args[6]), overflow=int(args[2][0]),
               skipped_chunk_share=1.0 - share)
    by = {c: graph_ms(lambda: fused.raster_tiles_earlyz(
        *args, **kw, cluster=c)) for c in fused.CLUSTER_SIZES}
    row["cluster"] = fused.raster_cluster(int(args[4].shape[0]),
                                          kw.get("max_count"))
    row["kernel_ms"] = by[row["cluster"]]
    row["kernel_ms_by_cluster"] = by
    row.update(raster_bound("raster_earlyz", args, out, share, 8 * scanned))
    row.update(k1_reference_ms(args[:8], args[10:13], args[13],
                               kw.get("max_count")))
    return row


def k11_launch(args, kw, out, max_count: int) -> dict:
    """One K11 call: :func:`window_stats` of its coarse windows (each
    slot's fine windows end where the coarse one does), the overflow
    entries, the subtile window lengths ``cntk`` (max, mean, 99th
    percentile), its kernel ms at the warp split the wrapper picks and at
    every split, its bound, and K1's kernel ms on the coarse windows of
    the same slots (:func:`k1_reference_ms`; ``max_count``: the frame's
    per-pass window cap)."""
    import torch

    from bibim_tpu_torch.ops import fused

    lb_al, cntk = args[6], args[7]
    coarse = torch.where(cntk > 0, lb_al + cntk,
                         torch.zeros_like(cntk)).amax(dim=1).to(torch.int32)
    ck = cntk.reshape(-1).float()
    row = dict(window_stats(coarse), overflow=int(args[2][0]),
               subtile_window_max=int(ck.max()),
               subtile_window_mean=float(ck.mean()),
               subtile_window_p99=float(torch.quantile(ck.cpu(), 0.99)))
    by = {p: graph_ms(lambda: fused.raster_tiles_fine(
        *args, **kw, parts=p)) for p in fused.FINE_PARTS}
    row["parts"] = fused.FINE_PARTS_DEFAULT
    row["kernel_ms"] = by[row["parts"]]
    row["kernel_ms_by_parts"] = by
    row.update(raster_bound("raster_fine", args, out))
    row.update(k1_reference_ms(
        (*args[:6], coarse.contiguous(), args[8]), args[9:12], args[12],
        max_count))
    return row


def k10_launch(args, kw, out, gcap: int, k1_call) -> dict:
    """The group-window K10 call as its launch sees it: slots, the group
    size, each group's window length (rows from ``win[g]`` its slots
    reach: max, mean, 99th percentile), the overflow entries, the prefix
    rows (``lb - lb_al``, the previous tile's rows a slot rescans) and
    the rows its ``gcap`` dropped — both from ``k1_call``, K1's call on
    the default frame of the same view, whose ``starts`` / ``counts``
    are the slots' true windows — its kernel ms (:func:`graph_ms`) at the
    cluster size its wrapper picks and at every size, its bound, and K1's
    kernel ms on the same derived ``starts`` / ``counts`` at every
    cluster size (:func:`k1_reference_ms`)."""
    import torch

    from bibim_tpu_torch.ops import fused

    rec, big_ids, n_big, pair_tri, ids, win, lb_al, cnt, init, group = \
        args[:10]
    k = int(ids.shape[0])
    rep = win.repeat_interleave(group)
    reach = torch.where(cnt > 0, lb_al + cnt, torch.zeros_like(cnt))
    wl = reach.reshape(-1, group).amax(dim=1).float().cpu()
    row = dict(window_stats(cnt), group=group, groups=k // group,
               gcap=gcap, overflow=int(n_big[0]),
               group_window_max=int(wl.max()),
               group_window_mean=float(wl.mean()),
               group_window_p99=float(torch.quantile(wl, 0.99)))
    starts, counts = k1_call[0][5], k1_call[0][6]
    lb = torch.clamp(starts - rep, 0, gcap)
    kept = torch.minimum(torch.clamp(gcap - lb, min=0), counts)
    if not (torch.equal(k1_call[0][4], ids)
            and torch.equal(lb - lb % 8, lb_al)):
        raise AssertionError("K10 launch: its slots are not the default "
                             "frame's, its bases not theirs aligned down")
    row.update(prefix_rows=int((lb - lb_al).sum()),
               dropped_rows=int((counts - kept).sum()))
    by = {c: graph_ms(lambda: fused.raster_tiles_gw(*args, **kw, cluster=c))
          for c in fused.CLUSTER_SIZES}
    row["cluster"] = fused.raster_cluster(k, kw.get("max_count"))
    row["kernel_ms"] = by[row["cluster"]]
    row["kernel_ms_by_cluster"] = by
    row.update(raster_bound("raster_gw", args, out))
    starts = (rep + lb_al).to(torch.int32)
    row.update(k1_reference_ms(
        (rec, big_ids, n_big, pair_tri, ids, starts, cnt, init),
        args[10:13], args[13], gcap + 7))
    return row


def k8_launch(call) -> dict:
    """The config-2 K8 call: pixels, slots, the table's shape, the
    wrapper's ms (CUDA events around the call), the kernel's device ms
    alone and the device ms of the torch geometry alone
    (``_mip_block_geometry`` and ``mip_geometry_planes``, :func:`device_ms`),
    and the bound."""
    from bibim_tpu_torch.ops import texture_quad as tq

    args, kw, _ = call
    table, mat_id, u, v = args[:4]
    tile = tuple(args[4:6]) or (kw.get("tile_h", 8), kw.get("tile_w", 128))
    out = tq.sample_mip_block_kernel(*args, **kw)
    cs = len(table.present)
    ops = u.numel() * cs * SAMPLER_TAPS["sample_mip_block"] * SAMPLE_TAP_OPS
    return dict(
        pixels=int(u.numel()), slots=cs, table=list(table.blocks.shape),
        wrapper_ms=cuda_ms(lambda: tq.sample_mip_block_kernel(*args, **kw)),
        kernel_ms=device_ms(lambda: tq.sample_mip_block_kernel(*args, **kw),
                            match="mip_block_kernel"),
        geometry_device_ms=device_ms(lambda: tq.mip_geometry_planes(
            tq._mip_block_geometry(table, mat_id, u, v, *tile))),
        **bound(sampler_bytes(args, out), ops))


def mip_rho_stress(table, nt: int, dev, seed: int = SEED, tile_h: int = 8,
                   tile_w: int = 128):
    """(mat_id, u, v), tiled (nt, tile_h·tile_w), whose 2×2 pixel quads
    put K8's footprint ρ on its level knife-edges: per quad a material
    (ids -1 and len(heights) too, out of range) and a level k from 0 to
    one past the material's last, ρ = 2^k or 1 to 4 float steps either
    side of it, along x or along y (the other axis at ρ/2). The quad's
    left / top pixels sit at u = 0 / v = 0 and the others at ±ρ / size,
    so the quad differences are ρ / size exactly and u, v go negative."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nq = nt * (tile_h // 2) * (tile_w // 2)
    nmat = len(table.heights)
    mat = rng.integers(-1, nmat + 1, nq)
    m0 = np.where((mat >= 0) & (mat < nmat), mat, 0)
    h0 = np.array([h[0] for h in table.heights], np.float32)[m0]
    w0 = np.array([w[0] for w in table.widths], np.float32)[m0]
    nlev = np.array([len(h) for h in table.heights])[m0]
    rho = np.ldexp(np.float32(1), rng.integers(0, nlev + 1)).astype(
        np.float32)
    for _ in range(4):
        step = rng.integers(-1, 2, nq)  # -1, 0, +1 float steps, 4 times
        rho = np.where(step > 0, np.nextafter(rho, np.float32(np.inf)),
                       np.where(step < 0, np.nextafter(rho, np.float32(0)),
                                rho)).astype(np.float32)
    along_x = rng.integers(0, 2, nq) == 1
    sign = np.where(rng.integers(0, 2, nq) == 1, 1, -1).astype(np.float32)
    dx = sign * np.where(along_x, rho, rho / 2) / w0
    dy = sign * np.where(along_x, rho / 2, rho) / h0
    row = np.arange(tile_h)[:, None]
    col = np.arange(tile_w)[None, :]
    q = ((row // 2) * (tile_w // 2) + col // 2).reshape(-1)
    q = (np.arange(nt)[:, None] * (nq // nt) + q[None, :])
    u = np.broadcast_to(col % 2, (tile_h, tile_w)).reshape(-1) * dx[q]
    v = np.broadcast_to(row % 2, (tile_h, tile_w)).reshape(-1) * dy[q]
    return tuple(torch.as_tensor(a).to(dev) for a in (
        mat[q].astype(np.int32), u.astype(np.float32), v.astype(np.float32)))


def check_mip_stress(table, dev, nt: int = 900) -> dict:
    """K8 on :func:`mip_rho_stress` inputs at a 1280×720 frame's tile
    count: every slot plane ``torch.equal`` to its plain version, else
    the run fails. Returns the pixels held and the levels selected."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq

    mat, u, v = mip_rho_stress(table, nt, dev)
    got = tq.sample_mip_block_kernel(table, mat, u, v)
    want = tq.sample_mip_block(table, mat, u, v)
    torch.cuda.synchronize()
    for slot in want:
        if not torch.equal(got[slot], want[slot]):
            bad = int((got[slot] != want[slot]).sum())
            raise AssertionError(f"K8 on the rho knife-edge stress: slot "
                                 f"{slot} differs at {bad} pixels")
    l0 = tq._mip_block_geometry(table, mat, u, v, 8, 128)["l0"]
    return dict(pixels=int(u.numel()),
                l0_hist=torch.bincount(l0.reshape(-1).long()).tolist())


def graph_ms(fn, reps: int = 20, busy: bool = False) -> float:
    """Device milliseconds of one ``fn`` call: ``fn`` captured once in a
    CUDA graph and replayed ``reps`` times between two CUDA events, so no
    host work (checks, allocation, ctypes) falls inside the timed span.
    ``busy``: about 20 ms of float32 matrix products run on the stream
    just before the timed replays, so that they find the card's clocks
    raised."""
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
    if busy:
        m = torch.ones((4096, 4096), device="cuda")
        for _ in range(12):
            m = m @ m * 1e-4
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


def device_profile(fn, reps: int = 5) -> dict:
    """Device milliseconds, device events (kernels, memcpy, memset) and
    host-side kernel launches (``cudaLaunchKernel`` and
    ``cudaLaunchKernelEx``) per ``fn`` call under ``torch.profiler``
    (:func:`profile_window`)."""
    from torch.autograd import DeviceType

    ka, us = profile_window(fn, reps)
    if not us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    return dict(
        device_ms=us / 1e3 / reps,
        device_events=sum(e.count for e in dev) / reps,
        launches=sum(e.count for e in ka if e.key in (
            "cudaLaunchKernel", "cudaLaunchKernelEx")) / reps)


def overlay_call(calls: list, comps: list, pick=None):
    """The captured K4 call with the most live slots (``pick``: its index)
    and the composite_overlay call that made it (one K4 call each)."""
    if len(calls) != len(comps):
        raise AssertionError(f"{len(calls)} K4 calls from {len(comps)} "
                             "composites")
    if pick is None:
        pick = max(range(len(calls)), key=lambda i: int(calls[i][0][7][0]))
    return calls[pick], comps[pick]


def k4_launch(call, comp) -> dict:
    """One K4 call as its launch sees it: slots, live slots (``n_live``,
    read on the host here only), the overflow rows every live slot scans
    first, the live slots' window lengths (max, mean, 99th percentile),
    the cluster size and cluster count its wrapper picks, its kernel ms
    (:func:`graph_ms`) at every cluster size, on a grid of one cluster a
    slot, after the card was kept busy (``busy``), and by
    :func:`profiled_ms`; K1's ms on
    the same tiles, windows and initial keys (``ids``, ``starts``,
    ``counts`` of the live slots, their scene keys; the colour planes) at
    every cluster size and at the size K1's rule picks for the call's
    window cap, and the device ms, device events and launches of the
    whole ``composite_overlay`` call that made it (binning, compaction,
    copies, the kernel)."""
    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops.sort import sort_keys

    args, kw, _ = call
    rec, big_ids, n_big, pair_tri, ids, starts, counts, n_live_t = args[:8]
    zkey, tiles = args[8], args[10:13]
    n_live = int(n_live_t[0])
    cnt = counts[:n_live].float().cpu()
    row = dict(slots=int(ids.shape[0]), live_slots=n_live,
               overflow=min(int(n_big[0]), int(big_ids.shape[0])),
               window_max=int(cnt.max()) if n_live else 0,
               window_mean=float(cnt.mean()) if n_live else 0.0,
               window_p99=float(torch.quantile(cnt, 0.99)) if n_live
               else 0.0)
    k = row["slots"]
    row["cluster"] = fused.overlay_cluster(kw.get("max_count"))
    row["clusters"] = min(k, fused.OVERLAY_BLOCKS // row["cluster"])
    by = {c: graph_ms(lambda: fused.overlay_tiles(*args, **kw, cluster=c))
          for c in fused.CLUSTER_SIZES}
    row["kernel_ms"] = by[row["cluster"]]
    row["kernel_ms_by_cluster"] = by
    # The grid sized from the list's length (one cluster a slot, the dead
    # ones leaving at once) instead of the fixed grid.
    row["kernel_ms_cluster_per_slot"] = graph_ms(
        lambda: fused.overlay_tiles(*args, **kw, clusters=k))
    row["kernel_ms_busy"] = graph_ms(
        lambda: fused.overlay_tiles(*args, **kw), reps=200, busy=True)
    row["kernel_profiled_ms"] = profiled_ms(
        lambda: fused.overlay_tiles(*args, **kw), "overlay_kernel")
    ids_l = ids[:n_live]
    init = (zkey[ids_l.long()] if zkey is not None else torch.zeros(
        (n_live, tiles[1] * tiles[2]), dtype=torch.int32,
        device=ids.device)).contiguous()
    args8 = (rec, big_ids, n_big, pair_tri, ids_l.contiguous(),
             starts[:n_live].contiguous(), counts[:n_live].contiguous(), init)
    cap = -(-comp[1]["max_candidates"] // 8) * 8
    by = {c: graph_ms(lambda: fused.raster_tiles(
        *args8, *tiles, ("cr", "cg", "cb"), cluster=c))
        for c in fused.CLUSTER_SIZES}
    row["k1_cluster"] = fused.raster_cluster(n_live, cap)
    row["k1_kernel_ms"] = by[row["k1_cluster"]]
    row["k1_kernel_ms_by_cluster"] = by
    row["k1_kernel_ms_busy"] = graph_ms(lambda: fused.raster_tiles(
        *args8, *tiles, ("cr", "cg", "cb"), cluster=row["k1_cluster"]),
        reps=200, busy=True)
    row["k1_profiled_ms_by_cluster"] = {c: profiled_ms(
        lambda: fused.raster_tiles(*args8, *tiles, ("cr", "cg", "cb"),
                                   cluster=c), "raster_kernel")
        for c in fused.CLUSTER_SIZES}
    cargs, ckw = comp
    ckw = dict(ckw, overlay=fused.overlay_tiles, sort=sort_keys)
    row["composite"] = device_profile(
        lambda: fused.composite_overlay(*cargs, **ckw))
    row["composite"]["graph_ms"] = graph_ms(
        lambda: fused.composite_overlay(*cargs, **ckw))
    return row


def overlay_bound(args, out) -> dict:
    """:func:`bound` of one K4 call: :func:`raster_bytes`, its live slots'
    coverage tests and their pixels' resolves as operations."""
    n_live, nb = int(args[7][0]), min(int(args[2][0]), int(args[1].shape[0]))
    npx = args[11] * args[12]
    tests = (nb * n_live + int(args[6][:n_live].sum())) * npx
    ops = tests * COVER_OPS + n_live * npx * RESOLVE_OPS
    return bound(raster_bytes("overlay", args, out), ops)


def check_overlay(call, comp, what: str) -> dict:
    """K4 on one captured call (bit-equal to its plain version), timed,
    with its launch line (:func:`k4_launch`) printed as ``<what> K4
    launch``."""
    import torch

    from bibim_tpu_torch.ops import fused

    args, kw, _ = call
    # The wrapper composites into its LDR argument: a copy of the input.
    work = args[:9] + (args[9].clone(),) + args[10:]
    got = fused.overlay_tiles(*work, **kw)
    want = fused.overlay_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: K4 differs from its plain version")
    changed = int((got != args[9]).any(dim=0).sum())
    if changed == 0:
        raise AssertionError(f"{what}: K4 composited no pixel")
    res = dict(max_abs_err=0.0, live_slots=int(args[7][0]),
               pixels_changed=changed,
               ms=cuda_ms(lambda: fused.overlay_tiles(*work, **kw)),
               plain_ms=cuda_ms(lambda: fused.overlay_tiles_plain(*args,
                                                                  **kw)),
               library_ms=None, whole_tensor_bytes=tensor_bytes(args, got),
               **overlay_bound(args, got))
    line = dict(k4_launch((work, kw, got), comp), **{k: res[k] for k in (
        "bound_ms", "bound_by", "bytes", "ops", "pixels_changed")})
    print(f"{what} K4 launch: " + json.dumps(line))
    return res


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
                            valid, kw.get("pair", 0), valid)
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


def check_kernels(calls: dict, comps: list) -> dict:
    """K1-K4 vs their plain versions on the 1080p frames' own inputs
    (``comps``: the frames' composite_overlay calls)."""
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
    # Block rows × 3 channels and quads × 7 channels.
    res["shade"] = dict(max_abs_err=max(errs + [vis_err]),
                        vis_max_abs_err=vis_err,
                        pixels=int(args[1].numel()), library_ms=None,
                        **shade_bound(args, kw, out, K2_BLOCK_TAP_CHANNELS),
                        **shade_times(shade_sampled, shade_sampled_plain,
                                      args, kw, hdr_kw),
                        vis_ms=cuda_ms(lambda: shade_sampled(*args,
                                                             **kw_vis)),
                        vis_plain_ms=cuda_ms(
                            lambda: shade_sampled_plain(*args, **kw_vis)),
                        tails_equal=check_tails(calls, "1080p"))

    res["overlay"] = check_overlay(*overlay_call(calls["overlay"], comps),
                                   "config-3 light spheres")
    return res


def check_kernels_c5(calls: dict, comps: list) -> dict:
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
        "overlay": check_overlay(*overlay_call(calls["overlay"], comps),
                                 "config-5 light spheres"),
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
        tq.sample_table_block, "sample_block",
        SAMPLER_TAPS["sample_block"], kernel="sample_block_kernel")
    res["sample_small"] = check_sampler(
        calls["sample_small"][0], tq.sample_rows_small,
        tq.sample_rows_small_plain, "sample_small",
        SAMPLER_TAPS["sample_small"])
    return res


def sampler_bytes(args, out, kw=None) -> int:
    """Bytes a sampler call (K6, K7, K8) must move: every pixel's inputs
    (uv and the material ids; K7: its row index and fractions), the
    distinct table rows the pixels read, the output planes."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq

    kw = kw or {}
    if isinstance(args[0], torch.Tensor):  # K7: (quads, idx, tx, ty, ..)
        idx = args[1]
        return rows_bytes(args[0], idx) + 12 * idx.numel() \
            + tensor_bytes(out)
    pair, valid = kw.get("pair_rows", 0), kw.get("valid")
    if isinstance(args[0], tq.BlockTable):  # K6: (table, u, v)
        table, u, v = args[:3]
        mat_id, tile = None, (8, kw.get("tile_w", 128))
    else:  # K8: (table, mat_id, u, v, tile_h, tile_w)
        table, mat_id, u, v = args[:4]
        tile = tuple(args[4:6]) or (8, 128)
    n_planes = 2 + (mat_id is not None)
    return (tables_bytes((table,), u, v, mat_id, *tile, pair=pair,
                         valid=valid)
            + (4 * n_planes + (valid is not None)) * u.numel()
            + tensor_bytes(out))


def check_sampler(call, kern, plain, name: str, taps: int,
                  kernel: str | None = None) -> dict:
    """A sampler kernel (K6, K7, K8) on one captured call: every slot
    plane bit-equal to its plain version; both timed. ``taps``: live taps
    per pixel and channel. ``kernel``: the kernel's name, whose device
    time a launch (``kernel_ms``) and ptxas rows the result adds."""
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
                **bound(sampler_bytes(args, got, kw), ops),
                ms=cuda_ms(lambda: kern(*args, **kw)),
                plain_ms=cuda_ms(lambda: plain(*args, **kw)),
                **({} if kernel is None else dict(
                    kernel_ms=device_ms(lambda: kern(*args, **kw), 20,
                                        kernel),
                    ptxas=ptxas_rows(kernel))))


def hud_input(width: int, height: int, yaw: float, fps: float = 60.0):
    """(text, (HudGeometry, mask)): the app's stats line for the camera at
    ``yaw`` (bibim_tpu/host/app.py's format), on build_hud_geometry's
    default line (48 characters at (6, 6), scale 2)."""
    from bibim_tpu_torch.host.hud import build_hud_geometry, hud_text_mask
    from bibim_tpu_torch.scene.camera import FreeLookCamera

    cam = FreeLookCamera(yaw=yaw)
    text = (f"{fps:5.1f} FPS  POS {cam.pos[0]:.1f} {cam.pos[1]:.1f} "
            f"{cam.pos[2]:.1f}  YAW {cam.yaw:.0f} PITCH {cam.pitch:.0f}")
    geom = build_hud_geometry(width, height)
    return text, (geom, hud_text_mask(text, geom.max_chars))


def check_hud_frame(img, off, geom) -> str:
    """The HUD frame against the HUD-off frame of its view: bit for bit
    outside the text rows (build_hud_geometry's default line: rows 6 to
    19), white glyph pixels inside them."""
    from bibim_tpu_torch.host.hud import GLYPH_H

    y0 = int(round((float(geom.cy[0]) + 1.0) * img.shape[0] / 2
                   - geom.dy * img.shape[0] / 2))
    y1 = y0 + GLYPH_H * int(round(geom.dy * img.shape[0]))
    same = (img == off).all(dim=-1)
    if not (bool(same[:y0].all()) and bool(same[y1:].all())):
        raise AssertionError(f"HUD frame differs from the HUD-off frame "
                             f"outside its text rows {y0}-{y1 - 1}")
    changed = ~same[y0:y1]
    lit = int((img[y0:y1] == 255).all(dim=-1)[changed].sum())
    if lit == 0 or lit != int(changed.sum()):
        raise AssertionError(f"HUD frame: {int(changed.sum())} pixels "
                             f"changed in the text rows, {lit} white")
    return (f"equal to the HUD-off frame outside rows {y0}-{y1 - 1}; "
            f"{lit} white glyph pixels")


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

    scene, mats, overlay, proj, fp, base = build_inputs(
        dev, C5_WIDTH, C5_HEIGHT, BASE5, enable_shadows=True,
        shadow_fit_batches=(0,), enable_ibl=True)
    ibl = make_ibl_sh(device=dev)
    print(f"config-5 frame: {C5_WIDTH}x{C5_HEIGHT}, shadows (map "
          f"{base.shadow_size}², fit to batch 0), analytic IBL "
          "(procedural sky), light spheres on, gizmo off")
    vbs = [view_block(y, proj, dev) for y in C5_YAWS]
    yaw_settings = [derive(scene, vb, base, mats, overlay,
                           f"config-5 yaw {y}")
                    for y, vb in zip(C5_YAWS, vbs)]

    calls: dict = {}
    comps: list = []
    with capture_composites(comps):
        for vb, settings in zip(vbs, yaw_settings):
            render_frame(scene, vb, fp, mats, overlay, settings, ibl=ibl,
                         kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres = check_kernels_c5(calls, comps)
    for k, v in kres.items():
        print(f"kernel {k}: " + json.dumps(v))
    del calls, comps

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
    for vb, settings in zip(vbs, yaw_settings):
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

    for i, ((out, cov), vb, settings) in enumerate(zip(outs, vbs,
                                                        yaw_settings)):
        ref = render_frame(scene, vb, fp, mats, overlay, settings, ibl=ibl,
                           kernels=PLAIN)["image"]
        summary = check_frame(i, out, cov, ref, (C5_HEIGHT, C5_WIDTH, 3),
                              "config-5")
        print(f"config-5 frame {i}: yaw {C5_YAWS[i]}, {frame_ms[i]:.2f} ms, "
              + summary)
    print(f"config-5 frame time median: {statistics.median(frame_ms):.2f} "
          f"ms (host clock around render_frame + synchronize, {name}, "
          f"{smi})")
    return kres, launches, (scene, mats, overlay, fp, ibl, vbs[0],
                            yaw_settings[0])


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
                      "K8", SAMPLER_TAPS["sample_mip_block"])
    args = calls["sample_mip_block"][0][0]
    res["sample_mip_block"] = dict(
        check_sampler(calls["sample_mip_block"][0],
                      tq.sample_mip_block_kernel, tq.sample_mip_block, "K8",
                      SAMPLER_TAPS["sample_mip_block"]),
        rho_stress=check_mip_stress(args[0], args[2].device))
    res["sample_small"] = check_sampler(
        calls["sample_small"][0], tq.sample_rows_small,
        tq.sample_rows_small_plain, "K7 routed",
        SAMPLER_TAPS["sample_small"])
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
    print("config-2 K8 launch: "
          + json.dumps(k8_launch(calls["sample_mip_block"][0])))
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


def c4_frames(dev, modes=C4_MODES):
    """Config 4's scene built on the card, then per view the host culling
    and the autotune of each raster mode in ``modes`` (the dense slot count
    picked by :func:`pick_dense_cap`), each printed. Returns (frames: a
    list of (label, frame data, view block, settings), frame parameters,
    materials)."""
    import dataclasses

    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import FrameParams, RenderSettings
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
                          pair_sampling=2)
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
        for mode, extra in modes:
            t0 = time.perf_counter()
            s, probe = autotune_settings(
                data, vb, dataclasses.replace(base, **extra),
                margin=C4_MARGIN, materials=mats)
            tune_ms = (time.perf_counter() - t0) * 1e3
            cands = dense_cap_candidates(s, probe, margin=C4_MARGIN)
            picks = None
            if len(cands) > 1:
                s, results = pick_dense_cap(cands, data, vb, fp, mats)
                picks = [{"dense_tile_cap": sx.dense_tile_cap,
                          "device_ms": ms} for ms, sx in results]
            derived = {k: getattr(s, k) for k in (
                "pair_sampling", "sample_route_caps", "max_candidates",
                "raster_passes", "merged_coverage", "dense_tile_cap",
                "raster_tile_cap", "live_tile_cap", "span_cap",
                "span_mid_cap", "overflow_cap", "pair_budget", "early_z",
                "fine_bins")}
            print(f"config-4 view {view_def[0]}, {mode}: autotune "
                  f"{tune_ms:.0f} ms; probe " + json.dumps(probe._asdict())
                  + "; derived " + json.dumps(derived)
                  + (f"; dense_tile_cap picked from {json.dumps(picks)}"
                     if picks else ""))
            if s.raster_passes < 2:
                raise AssertionError(f"config-4 {mode}: a single raster "
                                     "pass was derived")
            frames.append((f"{view_def[0]}, {mode}", data, vb, s))
    return frames, fp, mats


def run_config4(dev, smi: str, name: str):
    """The instanced path: per view host culling and the autotune of each
    raster mode, the kernel phases, then the counted frames."""
    import dataclasses

    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops.shading import shade_sampled
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame

    frames, fp, mats = c4_frames(dev)

    # Kernel phases on the frames' own inputs.
    calls: dict = {}
    setups: dict = {}
    per_frame = []
    with capture_setups(setups):
        for label, data, vb, s in frames:
            before = {k: len(v) for k, v in calls.items()}
            render_frame(data, vb, fp, mats, None, s,
                         kernels=capture_kernels(KERNELS, calls))
            per_frame.append({k: len(v) - before.get(k, 0)
                              for k, v in calls.items()})
    torch.cuda.synchronize()
    n_modes = len(C4_MODES)
    kres = {
        # Pass 0 of every frame that runs K1 (the default ones).
        "raster": check_raster(calls["raster"][0], "raster",
                               calls["raster"][1:]),
        # Passes 1..P-1 of the default and fine-bin frames.
        "raster_tail": check_raster_tail(calls["raster_tail"], setups),
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
        **shade_bound(args, kw, got, K2_BLOCK_TAP_CHANNELS),
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
    # K1's tail per default frame, and on the same views at the viewer
    # session's merged caps for 64 balls (88 passes of 1,024): its kernel
    # ms against its bound, the wrapper and the plain ms.
    tails = iter(calls["raster_tail"])
    for (label, data, vb, s), n in zip(frames, per_frame):
        row_calls = [next(tails) for _ in range(n.get("raster_tail", 0))]
        if s.early_z or s.fine_bins or not row_calls:
            continue
        print(f"config-4 K1 tail, {label}, {s.raster_passes} passes of "
              f"{s.max_candidates}: "
              + json.dumps(check_raster_tail(row_calls, setups)))
        merged = dataclasses.replace(s, max_candidates=C4_SESSION_CAPS[0],
                                     raster_passes=C4_SESSION_CAPS[1])
        got: dict = {}
        with capture_setups(setups):
            out = render_frame(data, vb, fp, mats, None, merged,
                               kernels=capture_kernels(KERNELS, got))
        torch.cuda.synchronize()
        if any(int(d) for d in out["bin_diag"]):
            raise AssertionError(f"config-4 {label} at the session caps "
                                 "dropped geometry")
        print(f"config-4 K1 tail, {label}, {merged.raster_passes} passes "
              f"of {merged.max_candidates} (session caps): "
              + json.dumps(check_raster_tail(got["raster_tail"], setups)))
        del got
    # K9 per launch (every pass of each early-z frame) and K11 per launch
    # (pass 0 of each fine-bin frame), each beside K1 on the same windows:
    # is a launch held back by its longest window?
    ez = iter(calls["raster_earlyz"])
    fine = iter(calls["raster_fine"])
    for (label, _, _, s), n in zip(frames, per_frame):
        for p in range(n.get("raster_earlyz", 0)):
            a, k, o = next(ez)
            print(f"config-4 K9 launch, {label}, pass {p}: "
                  + json.dumps(k9_launch(a, k, o)))
        for _ in range(n.get("raster_fine", 0)):
            a, k, o = next(fine)
            print(f"config-4 K11 launch, {label}, pass 0: " + json.dumps(
                k11_launch(a, k, o, -(-s.max_candidates // 8) * 8)))
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
                fused.raster_tiles_earlyz, fused.raster_tiles_fine,
                fused.raster_tiles_tail)
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
                "raster_fine": fused.raster_tiles_fine.launches,
                "raster_tail": fused.raster_tiles_tail.launches}
    print("config-4 main-path launches: " + json.dumps(launches))
    # Each default and fine-bin frame: pass 0 and one tail; early-z
    # frames keep K9's pass loop.
    n_tail = sum(not s.early_z and s.raster_passes > 1
                 for _, _, _, s in frames)
    if launches["raster_tail"] != n_tail:
        raise AssertionError(f"{launches['raster_tail']} K1 tail launches "
                             f"for {n_tail} multi-pass frames")
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


def gizmo_standin():
    """A coloured stand-in for gizmo.obj: three bars along the axes (red
    x, green y, blue z) from a grey ball, turned so that the camera sees
    all three, 360 triangles (gizmo.obj has 363)."""
    import numpy as np

    from bibim_tpu_torch.scene.meshgen import (
        Mesh,
        generate_cube_mesh,
        generate_uv_sphere_mesh,
    )

    parts = [(generate_uv_sphere_mesh(1.5, 18, 10), np.eye(3), np.zeros(3),
              (0.6, 0.6, 0.6))]
    for axis, color in enumerate(((1, 0.2, 0.2), (0.2, 1, 0.2),
                                  (0.2, 0.2, 1))):
        scale = np.full(3, 0.6)
        scale[axis] = 6.0
        shift = np.zeros(3)
        shift[axis] = 3.0
        parts.append((generate_cube_mesh(1.0), np.diag(scale), shift, color))
    a, b = np.radians(25.0), np.radians(35.0)
    rot = (np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]])
           @ np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]]))
    pos, nrm, uvs, tan, col, idx = [], [], [], [], [], []
    base = 0
    for mesh, scale, shift, color in parts:
        pos.append((mesh.positions @ scale + shift) @ rot.T)
        nrm.append(mesh.normals @ rot.T)
        tan.append(mesh.tangents @ rot.T)
        uvs.append(mesh.uvs)
        col.append(np.tile(np.float32(color), (len(mesh.positions), 1)))
        idx.append(mesh.indices + base)
        base += len(mesh.positions)
    f32 = np.float32
    return Mesh(positions=np.concatenate(pos).astype(f32),
                uvs=np.concatenate(uvs).astype(f32),
                normals=np.concatenate(nrm).astype(f32),
                tangents=np.concatenate(tan).astype(f32),
                indices=np.concatenate(idx).astype(np.int32),
                colors=np.concatenate(col).astype(f32))


def run_config1(dev, smi: str, name: str):
    """BASELINE config 1: the flat-shaded 512² frame of GizmoScene on the
    stand-in mesh (K1 and K3 only: no material, no light) on bench.py's
    settings (bench_gizmo: the default capacities); its K1 and K3 calls
    against their plain versions, then the frame with the counters reset
    just before, against the all-plain render."""
    import numpy as np
    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import (
        KERNELS,
        PLAIN,
        FrameParams,
        RenderSettings,
        ViewBlock,
        render_frame,
    )
    from bibim_tpu_torch.scene.camera import FreeLookCamera
    from bibim_tpu_torch.scene.gizmoscene import (
        GIZMO_CAMERA_DISTANCE,
        GIZMO_FOV_DEGREES,
        GizmoScene,
    )

    # No device argument: GizmoScene builds on the card.
    scene = GizmoScene(mesh=gizmo_standin()).scene_data()
    if scene.batches[0].positions.device.type != "cuda":
        raise AssertionError("GizmoScene() built on "
                             f"{scene.batches[0].positions.device}")
    cam = FreeLookCamera(pos=np.float32([0.0, 0.0, -GIZMO_CAMERA_DISTANCE]))
    vb = ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=dev),
        proj=m3.perspective(GIZMO_FOV_DEGREES, 1.0, 0.1, 1000.0, device=dev),
        view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(0, dtype=torch.int32, device=dev))
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(0, dtype=torch.int32, device=dev),
        exposure=torch.tensor(1.0, dtype=torch.float32, device=dev))
    tris = int(scene.batches[0].positions.shape[0]) // 3
    print(f"config-1 frame: {C1_SIZE}x{C1_SIZE}, flat shading, the gizmo "
          f"camera, a {tris}-triangle coloured stand-in for gizmo.obj, no "
          "lights, tone map off")
    s = RenderSettings(width=C1_SIZE, height=C1_SIZE, shading="flat",
                       show_lights=False, show_gizmo=False,
                       outputs="image+diag")

    calls: dict = {}
    render_frame(scene, vb, fp, None, None, s,
                 kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres = {"raster": check_raster(calls["raster"][0]),
            "sort": check_sorts(calls["sort"])}
    for k, v in kres.items():
        print(f"kernel {k} (config 1): " + json.dumps(v))
    del calls

    for fn in (fused.raster_tiles, sort_keys):
        fn.launches = 0
    sort_keys.device_launches = 0
    cover: list = []

    def raster_counted(*args, **kw):
        zk, f = KERNELS.raster(*args, **kw)
        cover.append(f[args[11].index("idf")] >= 0.5)
        return zk, f

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_frame(scene, vb, fp, None, None, s,
                       kernels=KERNELS._replace(raster=raster_counted))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"raster": fused.raster_tiles.launches,
                "sort": sort_keys.launches}
    print("config-1 main-path launches: " + json.dumps(launches))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "config-1 frame")
    ref = render_frame(scene, vb, fp, None, None, s, kernels=PLAIN)["image"]
    summary = check_frame(0, out, cover[0], ref, (C1_SIZE, C1_SIZE, 3),
                          "config-1")
    colours = len(torch.unique(out["image"].reshape(-1, 3), dim=0))
    print(f"config-1 frame: {ms:.2f} ms ({name}, {smi}), {colours} "
          "colours, " + summary)
    return kres, launches


def routed_view(proj, dev):
    """The routed frame's close-up view (CLOSE_UP_POS, CLOSE_UP_PITCH)."""
    import numpy as np
    import torch

    from bibim_tpu_torch.pipeline import ViewBlock
    from bibim_tpu_torch.scene.camera import FreeLookCamera

    cam = FreeLookCamera(pos=np.float32(CLOSE_UP_POS), pitch=CLOSE_UP_PITCH)
    return ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=dev), proj=proj,
        view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(0, dtype=torch.int32, device=dev))


def check_shade_pairs(calls: list) -> dict:
    """Every captured K2 call at a pair level against its plain version
    (``assert_shade_close``; the fused tail against the torch tail,
    ``torch.equal``), each timed: wrapper, kernel and plain ms, the
    kernel at pair level 0 on the same inputs, and the bound, whose bytes
    count one block row a group; with the ptxas rows of K2's
    instantiations at that level and at level 0."""
    import torch

    from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain

    res = []
    for args, kw, _ in calls:
        got = shade_sampled(*args, **kw)
        want = shade_sampled_plain(*args, **kw)
        torch.cuda.synchronize()
        err = assert_shade_close(got, want, f"K2 pair level {kw['pair']}")
        hdr_kw = dict(kw, quantize_hdr=False, tonemap=False)
        valid = args[6]
        live = valid.any(dim=1)
        res.append(dict(
            max_abs_err=err, pair=kw["pair"], slots=int(valid.shape[0]),
            live_slots=int(live.sum()), pixels=int(valid.numel()),
            library_ms=None,
            **shade_bound(args, kw, got, K2_BLOCK_TAP_CHANNELS),
            **shade_times(shade_sampled, shade_sampled_plain, args, kw,
                          hdr_kw),
            level0_kernel_ms=device_ms(
                lambda: shade_sampled(*args, **dict(kw, pair=0)), 20,
                "bb::shade_kernel"),
            ptxas={lvl: ptxas_rows(rf"shade_kernel<\w+, {lvl},")
                   for lvl in (kw["pair"], 0)}))
    tails = check_tails({"shade": calls}, "pair-level K2")
    return dict(res[0], calls=res, tails_equal=tails)


def run_pair_paths(dev, smi: str, name: str, c3, c5):
    """Pair-rate sampling and PCF on the H100: the routed close-up (K2 at
    pair level 2 on the clean tiles, per pixel on the rest, torch.equal
    to its pair-0 frame), the 1080p pair_lossy frame (K2 at level 2), the
    config-5 pair_lossy frame (K6 at level 2 on the G-buffer path) and the
    config-5 pair_visibility frame. Every K2 and K6 launch at a pair
    level against its plain version; then the four frames with the
    counters reset just before, each against the all-plain render, and
    the routed frame against its exact frame in device ms and launches."""
    import dataclasses

    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.shading import shade_sampled, shade_tonemap
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame

    scene, mats, overlay, proj, fp, base3, s3 = c3
    scene5, mats5, overlay5, fp5, ibl, vb5, s5 = c5
    vb_close = routed_view(proj, dev)
    s_route = derive(scene, vb_close, base3, mats, overlay,
                     "routed close-up")
    if not s_route.pair_sampling or s_route.sample_route_caps is None:
        raise AssertionError("the close-up's probe turned routing off")
    s_exact = dataclasses.replace(s_route, pair_sampling=0,
                                  sample_route_caps=None)
    lossy = dict(pair_sampling=2, pair_lossy=True)
    frames = [
        ("routed close-up", scene, vb_close, mats, overlay, s_route, None,
         fp),
        ("1080p pair_lossy", scene, view_block(YAWS[0], proj, dev), mats,
         overlay, dataclasses.replace(s3, **lossy), None, fp),
        ("config-5 pair_lossy", scene5, vb5, mats5, overlay5,
         dataclasses.replace(s5, **lossy), ibl, fp5),
        ("config-5 pair_visibility", scene5, vb5, mats5, overlay5,
         dataclasses.replace(s5, pair_visibility=True), ibl, fp5),
    ]
    calls: dict = {}
    for _, sc, vb, m, ov, st, ib, f in frames:
        render_frame(sc, vb, f, m, ov, st, ibl=ib,
                     kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    k2 = [c for c in calls["shade"] if c[1].get("pair")]
    k6 = [c for c in calls["sample_block"] if c[1].get("pair_rows")]
    if not k2 or not k6:
        raise AssertionError(f"{len(k2)} K2 and {len(k6)} K6 launches at a "
                             "pair level")
    kres = {"shade_pair": check_shade_pairs(k2),
            "sample_block_pair": [check_sampler(
                c, tq.sample_table_block_kernel, tq.sample_table_block,
                "sample_block", SAMPLER_TAPS["sample_block"],
                kernel=f"sample_block_pair_kernel<{c[1]['pair_rows']},")
                for c in k6]}
    for r, (args, kw, _) in zip(kres["sample_block_pair"], k6):
        r["level0_kernel_ms"] = device_ms(
            lambda: tq.sample_table_block_kernel(*args), 20,
            "sample_block_kernel")
        r["level0_ptxas"] = ptxas_rows("sample_block_kernel<")
    kres["sample_block_pair"] = dict(kres["sample_block_pair"][0],
                                     calls=kres["sample_block_pair"])
    for k, v in kres.items():
        print(f"kernel {k}: " + json.dumps(v))
    del calls, k2, k6

    counters = (fused.raster_tiles, sort_keys, fused.overlay_tiles,
                shade_sampled, shade_tonemap, tq.sample_table_block_kernel,
                tq.sample_rows_small)
    for fn in counters:
        fn.launches = 0
    shade_sampled.pair_launches = 0
    tq.sample_table_block_kernel.pair_launches = 0
    sort_keys.device_launches = 0
    cover: list = []

    def raster_counted(*args, **kw):  # the main pass runs first
        zk, f = KERNELS.raster(*args, **kw)
        cover.append(f[args[11].index("idf")] >= 0.5)
        return zk, f

    counted = KERNELS._replace(raster=raster_counted)
    outs = []
    for what, sc, vb, m, ov, st, ib, f in frames:
        cover.clear()
        outs.append((render_frame(sc, vb, f, m, ov, st, ibl=ib,
                                  kernels=counted), cover[0]))
    torch.cuda.synchronize()
    launches = {"raster": fused.raster_tiles.launches,
                "sort": sort_keys.launches,
                "overlay": fused.overlay_tiles.launches,
                "shade": shade_sampled.launches,
                "shade_pair": shade_sampled.pair_launches,
                "shade_gbuffer": shade_tonemap.launches,
                "sample_block": tq.sample_table_block_kernel.launches,
                "sample_block_pair":
                    tq.sample_table_block_kernel.pair_launches,
                "sample_small": tq.sample_rows_small.launches}
    print("pair-path launches (4 frames): " + json.dumps(launches))
    print(k3_device_line("pair-path main path:"))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "pair-path frames")

    exact = render_frame(scene, vb_close, fp, mats, overlay, s_exact)
    if not torch.equal(outs[0][0]["image"], exact["image"]):
        raise AssertionError("the routed frame differs from its pair-0 "
                             "frame")
    for i, ((out, cov), (what, sc, vb, m, ov, st, ib, f)) in enumerate(
            zip(outs, frames)):
        ref = render_frame(sc, vb, f, m, ov, st, ibl=ib,
                           kernels=PLAIN)["image"]
        summary = check_frame(i, out, cov, ref, tuple(out["image"].shape),
                              what)
        print(f"pair-path frame {i}: {what}, " + summary)
    print("routed close-up: torch.equal to its pair-0 frame")

    # Routed against exact, in turns exact, routed, routed, exact.
    prof = {}
    for label, st in (("exact", s_exact), ("routed", s_route),
                      ("routed", s_route), ("exact", s_exact)):
        prof.setdefault(label, []).append(device_profile(
            lambda: render_frame(scene, vb_close, fp, mats, overlay, st)))
    print(f"routed close-up vs its exact frame ({name}, {smi}): "
          + json.dumps(prof))
    return kres, launches


# The new-path phase: forward lighting, anisotropic taps, the legacy
# bindings and (T, 3) geometry, the TBN view and MeshScene, on the
# config-3 stand-in at 1080p and the config-2 cubes at 720p.
NEW_TAPS = (2, 4)
SHADOWS = dict(enable_shadows=True, shadow_fit_batches=(0,),
               shadow_size=1024)
# The MeshScene stand-in: a torus (R 1, r 0.35) of 96 × 48 quads written
# as an OBJ with uvs and normals.
TORUS = (96, 48)


def shared_vertex_batch(mesh, model, dev):
    """A hand-built DrawBatch: the mesh's shared (indexed) vertices, no
    corner planes, so the frame takes the (T, 3) path."""
    import numpy as np
    import torch

    from bibim_tpu_torch.scene.scene import DrawBatch

    model = np.asarray(model, np.float32).reshape(-1, 4, 4)
    inv = np.linalg.inv(model.astype(np.float64)).astype(np.float32)
    colors = (mesh.colors if mesh.colors is not None
              else np.ones_like(mesh.positions))

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=dev)

    return DrawBatch(positions=t(mesh.positions), uvs=t(mesh.uvs),
                     normals=t(mesh.normals), tangents=t(mesh.tangents),
                     colors=t(colors), indices=t(mesh.indices, np.int32),
                     model=t(model), inv_model=t(inv))


def shared_vertex_standin(scene, dev):
    """The config-3 stand-in (the 10,000-triangle ball, the ground plane)
    as hand-built shared-vertex batches with the same triangles."""
    from bibim_tpu_torch.scene.meshgen import (
        generate_plane_mesh,
        generate_uv_sphere_mesh,
    )
    from bibim_tpu_torch.scene.scene import SceneData

    ball = generate_uv_sphere_mesh(100.0, 100, 51)
    plane = generate_plane_mesh()
    models = [b.model.cpu().numpy() for b in scene.batches]
    return SceneData(batches=(shared_vertex_batch(ball, models[0], dev),
                              shared_vertex_batch(plane, models[1], dev)),
                     lights=scene.lights)


def write_torus_obj(path) -> int:
    """A torus OBJ (``TORUS`` quads, uvs, normals); returns its triangle
    count."""
    import numpy as np

    nu, nv = TORUS
    a = 2 * np.pi * np.arange(nu) / nu
    b = 2 * np.pi * np.arange(nv) / nv
    aa, bb = np.meshgrid(a, b, indexing="ij")
    x = (1.0 + 0.35 * np.cos(bb)) * np.cos(aa)
    y = 0.35 * np.sin(bb)
    z = (1.0 + 0.35 * np.cos(bb)) * np.sin(aa)
    n = np.stack([np.cos(bb) * np.cos(aa), np.sin(bb),
                  np.cos(bb) * np.sin(aa)], -1).reshape(-1, 3)
    lines = [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
             for p in np.stack([x, y, z], -1).reshape(-1, 3)]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in zip(
        (aa / (2 * np.pi)).reshape(-1) * 4, (bb / (2 * np.pi)).reshape(-1))]
    lines += [f"vn {q[0]:.6f} {q[1]:.6f} {q[2]:.6f}" for q in n]

    def k(i, j):
        return (i % nu) * nv + (j % nv) + 1

    for i in range(nu):
        for j in range(nv):
            c = [k(i, j), k(i, j + 1), k(i + 1, j + 1), k(i + 1, j)]
            lines.append("f " + " ".join(f"{q}/{q}/{q}" for q in c))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 2 * nu * nv


# The stand-in resource root (:func:`write_standin_resources`): the
# ShaderBall.fbx stand-in is build_inputs' ball, 10,000 triangles.
BALL_SPHERE = (100.0, 100, 51)
STANDIN_MATERIALS = ("standin_a", "standin_b")


def _fbx_node(pos: int, name: str, props=(), children=()) -> bytes:
    """One node record of a binary FBX 7.4 file (32-bit offsets) at file
    offset ``pos``; ``children`` are (name, props, children) tuples. A
    node with children ends with the 13-byte null record."""
    import struct

    import numpy as np

    body = b""
    for p in props:
        if isinstance(p, str):
            data = p.encode()
            body += b"S" + struct.pack("<I", len(data)) + data
        elif isinstance(p, np.ndarray):
            code = {np.dtype("<f8"): b"d", np.dtype("<i4"): b"i"}[p.dtype]
            data = np.ascontiguousarray(p).tobytes()
            body += code + struct.pack("<III", p.size, 0, len(data)) + data
        else:
            body += b"L" + struct.pack("<q", int(p))
    end = pos + 13 + len(name) + len(body)
    nested = b""
    for child in children:
        rec = _fbx_node(end, *child)
        nested += rec
        end += len(rec)
    if children:
        nested += b"\0" * 13
        end += 13
    return (struct.pack("<III", end, len(props), len(body))
            + struct.pack("<B", len(name)) + name.encode() + body + nested)


def write_fbx_mesh(path, mesh) -> int:
    """``mesh`` as a minimal binary FBX 7.4 file: one Objects/Geometry node
    with the nodes ``assets/fbx.py load_fbx_mesh`` reads — ``Vertices``
    (the shared positions), ``PolygonVertexIndex`` (one polygon a
    triangle, its last corner bit-inverted), normals by polygon vertex
    (Direct) and uvs by polygon vertex through ``UVIndex``
    (IndexToDirect); uncompressed arrays. Returns the triangle count."""
    import struct

    import numpy as np

    idx = np.asarray(mesh.indices, np.int64)
    pvi = idx.astype(np.int32).copy()
    pvi[:, 2] = ~pvi[:, 2]
    flat = idx.reshape(-1)

    def f64(a):
        return np.asarray(a, np.float32).astype("<f8").reshape(-1)

    geometry = ("Geometry", (1000, "Ball\0\x01Geometry", "Mesh"), (
        ("Vertices", (f64(mesh.positions),), ()),
        ("PolygonVertexIndex", (pvi.reshape(-1).astype("<i4"),), ()),
        ("LayerElementNormal", (0,), (
            ("MappingInformationType", ("ByPolygonVertex",), ()),
            ("ReferenceInformationType", ("Direct",), ()),
            ("Normals", (f64(np.asarray(mesh.normals)[flat]),), ()))),
        ("LayerElementUV", (0,), (
            ("MappingInformationType", ("ByPolygonVertex",), ()),
            ("ReferenceInformationType", ("IndexToDirect",), ()),
            ("UV", (f64(mesh.uvs),), ()),
            ("UVIndex", (flat.astype("<i4"),), ())))))
    head = b"Kaydara FBX Binary  \0\x1a\0" + struct.pack("<I", 7400)
    data = head + _fbx_node(len(head), "Objects", (), (geometry,))
    with open(path, "wb") as f:
        f.write(data + b"\0" * 13)
    return len(idx)


def write_standin_resources(root, seed: int = SEED, map_size: int = 2048,
                            cube_sizes=C2_ALBEDOS):
    """A resource root for the host (Session, the viewer, the app) where
    the real assets are missing, under ``root``: ``config.toml`` (its
    ``common_root`` is ``root``); ``pbr/default`` with 16² maps of all six
    kinds and two materials (``STANDIN_MATERIALS``) with seeded
    ``map_size``² albedo / normal / roughness PNGs (their metallic, ao and
    height fall back to the default's; at 2048² the big maps bind as one
    block table, as the headline's do); ``gizmo.obj``
    (:func:`gizmo_standin`); ``ShaderBall.fbx`` (build_inputs' ball,
    :func:`write_fbx_mesh`); the cube scene's ``uv_debug.png`` and
    ``texture.jpg`` (seeded, ``cube_sizes``). Returns the config path,
    for ``utils.config.init_resource_root``."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh

    root = Path(root).resolve()
    rng = np.random.default_rng(seed)

    def image(path, n, channels, **kw):
        path.parent.mkdir(parents=True, exist_ok=True)
        px = rng.integers(0, 256, (n, n, channels), dtype=np.uint8)
        Image.fromarray(px[:, :, 0] if channels == 1 else px).save(path,
                                                                    **kw)

    for kind, ch in (("albedo", 3), ("metallic", 1), ("roughness", 1),
                     ("ao", 1), ("normal", 3), ("height", 1)):
        image(root / "pbr" / "default" / f"{kind}.png", 16, ch)
    for name in STANDIN_MATERIALS:
        for kind, ch in (("albedo", 3), ("normal", 3), ("roughness", 1)):
            image(root / "pbr" / name / f"{kind}.png", map_size, ch,
                  compress_level=0)
    image(root / "uv_debug.png", cube_sizes[0], 4, compress_level=0)
    image(root / "texture.jpg", cube_sizes[1], 3, quality=90)

    # gizmo.obj: the stand-in's parts as MTL materials (their Kd the
    # part's colour, baked per vertex by the OBJ loader).
    gizmo = gizmo_standin()
    colors = sorted({tuple(c) for c in gizmo.colors.tolist()})
    (root / "gizmo.mtl").write_text("".join(
        f"newmtl c{k}\nKd {c[0]} {c[1]} {c[2]}\n"
        for k, c in enumerate(colors)))
    lines = ["mtllib gizmo.mtl"]
    lines += [f"v {p[0]!r} {p[1]!r} {p[2]!r}"
              for p in gizmo.positions.tolist()]
    lines += [f"vn {q[0]!r} {q[1]!r} {q[2]!r}"
              for q in gizmo.normals.tolist()]
    current = None
    for tri in gizmo.indices.tolist():
        k = colors.index(tuple(gizmo.colors[tri[0]].tolist()))
        if k != current:
            lines.append(f"usemtl c{k}")
            current = k
        lines.append("f " + " ".join(f"{i + 1}//{i + 1}" for i in tri))
    (root / "gizmo.obj").write_text("\n".join(lines) + "\n")
    write_fbx_mesh(root / "ShaderBall.fbx",
                   generate_uv_sphere_mesh(*BALL_SPHERE))
    config = root / "config.toml"
    config.write_text(f'[resource_path]\ncommon_root = "{root}"\n'
                      f'shader_root = "{root / "shaders"}"\n')
    return config

def check_new_path_launches(per_frame: list, rows: dict) -> dict:
    """Every captured K1, K2, K5, K6, K7 and K8 launch of the new-path
    frames (``per_frame``: each frame's captured calls) against its plain
    version — K1 zkey and tri_id bit-equal and its attribute planes within
    1e-3, K6 / K7 / K8 bit-equal, K2 and K5 within ``_assert_close``
    (their fused fp16 + tone-map tails ``torch.equal`` to the torch tail)
    — and one timed row per kernel and path for the kernels line: the
    first launch of the frame ``rows[name]``."""
    import torch

    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.shading import (
        shade_sampled,
        shade_sampled_plain,
        shade_tonemap,
        shade_tonemap_plain,
    )

    shadow = shadow_fields()

    every: dict = {}
    firsts: list = []
    for c in per_frame:
        first: dict = {}
        for name, xs in c.items():
            for x in xs:
                key = ("raster_shadow_pass" if name == "raster"
                       and tuple(x[0][11]) == shadow else name)
                every.setdefault(key, []).append(x)
                first.setdefault(key, x)
        firsts.append(first)
    from bibim_tpu_torch.ops import fused

    res = {}
    for key in ("raster", "raster_shadow_pass"):
        call = firsts[rows[key]][key]
        res[key] = check_raster(call, calls=[x for x in every[key]
                                             if x is not call])
        args, kw, _ = call
        res[key]["kernel_ms"] = device_ms(
            lambda: fused.raster_tiles(*args, **kw), 20, "raster_kernel")
    for name, kern, plain, kname in (
            ("shade", shade_sampled, shade_sampled_plain,
             "bb::shade_kernel"),
            ("shade_gbuffer", shade_tonemap, shade_tonemap_plain,
             "bb::gbuffer_shade_kernel")):
        errs = []
        for args, kw, _ in every[name]:
            got, want = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            errs.append(assert_shade_close(got, want, f"new paths {name}"))
        args, kw, _ = firsts[rows[name]][name]
        out = kern(*args, **kw)
        taps = K2_BLOCK_TAP_CHANNELS if name == "shade" else 0
        res[name] = dict(max_abs_err=max(errs), checked_calls=len(errs),
                         pixels=int(args[6].numel()), library_ms=None,
                         **shade_bound(args, kw, out, taps,
                                       sampled=name == "shade"),
                         ms=cuda_ms(lambda: kern(*args, **kw)),
                         plain_ms=cuda_ms(lambda: plain(*args, **kw)),
                         kernel_ms=device_ms(lambda: kern(*args, **kw), 20,
                                             kname))
        if name == "shade":
            # The forward launch with the deferred frame's fp16 G-buffer,
            # on the same inputs.
            res[name]["quantized_kernel_ms"] = device_ms(
                lambda: kern(*args, **dict(kw, quantize=True)), 20, kname)
    if firsts[rows["shade"]]["shade"][1].get("quantize") is not False:
        raise AssertionError("the forward K2 launch quantized its G-buffer")
    res["shade"]["tails_equal"] = check_tails(every, "new paths")
    for name, kern, plain, kname in (
            ("sample_block", tq.sample_table_block_kernel,
             tq.sample_table_block, "sample_block_kernel"),
            ("sample_small", tq.sample_rows_small,
             tq.sample_rows_small_plain, "sample_small_kernel"),
            ("sample_mip_block", tq.sample_mip_block_kernel,
             tq.sample_mip_block, "mip_block_kernel")):
        call = firsts[rows[name]][name]
        for x in every[name]:
            if x is call:  # checked by check_sampler below
                continue
            args, kw, _ = x
            got, want = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            for slot in want:
                if not torch.equal(got[slot], want[slot]):
                    raise AssertionError(f"new paths {name} slot {slot} "
                                         "differs from its plain version")
        res[name] = dict(check_sampler(call, kern, plain, name,
                                       SAMPLER_TAPS[name], kernel=kname),
                         checked_calls=len(every[name]))
    return res


def run_new_paths(dev, smi: str, name: str, c3):
    """The paths this port added last, on repository-only stand-ins: the
    config-3 stand-in at 1080p forward (settings autotuned as config 3's),
    forward with shadows and analytic IBL, at 2 and 4 anisotropic taps,
    on hand-built shared-vertex batches (the (T, 3) path) with and without
    shadows and with the TBN view; the config-2 cubes at 2 taps and on
    per-material MaterialTextures; a MeshScene frame of an OBJ written to
    a temporary directory. Every K1, K2, K5, K6, K7 and K8 launch against
    its plain version; the frames with the counters reset just before,
    each against the all-plain render; each new frame's device ms and
    launches beside its twin's."""
    import dataclasses
    import os
    import tempfile

    import torch

    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.ops.shading import shade_sampled, shade_tonemap
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.pipeline import KERNELS, PLAIN, render_frame
    from bibim_tpu_torch.scene.cube import cube_material_tables, seeded_albedos
    from bibim_tpu_torch.scene.meshscene import MeshScene

    scene, mats, overlay, proj, fp, base, settings = c3
    vb = view_block(YAWS[0], proj, dev)
    ibl = make_ibl_sh(device=dev)
    fwd = derive(scene, vb, dataclasses.replace(base, deferred=False), mats,
                 overlay, "1080p forward")
    shadowed = derive(scene, vb, dataclasses.replace(base, **SHADOWS), mats,
                      overlay, "1080p shadows")
    stretch = dataclasses.replace(shadowed, enable_ibl=True)
    sv_scene = shared_vertex_standin(scene, dev)
    legacy = dict(geometry="legacy", sequential_tris=False)
    c2_scene, c2_mats, c2_proj, _, c2_settings = cube_inputs(dev)
    c2_vb = cube_view(C2_CAMERA_Z[0], c2_proj, dev)
    c2_textures = cube_material_tables(seeded_albedos(SEED, C2_ALBEDOS),
                                       device=dev, with_mips=False)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "torus.obj")
        n_torus = write_torus_obj(path)
        mesh_scene = MeshScene(path=path, device=dev).scene_data()
    mesh_settings = derive(mesh_scene, vb, base, mats, overlay,
                           "1080p MeshScene")
    print(f"new paths: forward, shadows + IBL, {NEW_TAPS} taps on the "
          f"config-3 stand-in ({WIDTH}x{HEIGHT}); its (T, 3) twin "
          f"({sum(int(b.indices.shape[0]) for b in sv_scene.batches)} "
          "triangles over shared vertices); config-2 cubes at 2 taps and "
          f"on MaterialTextures; MeshScene of a {n_torus}-triangle torus "
          "OBJ")

    c3f = (scene, mats, overlay, vb, None)
    svf = (sv_scene, mats, overlay, vb, None)
    c2f = (c2_scene, c2_mats, None, c2_vb, None)
    # (label, (scene, materials, overlay, view, ibl), settings, twin index)
    frames = [
        ("1080p deferred", c3f, settings, None),
        ("1080p forward", c3f, fwd, 0),
        ("1080p deferred shadows + IBL", c3f[:4] + (ibl,), stretch, None),
        ("1080p forward shadows + IBL", c3f[:4] + (ibl,),
         dataclasses.replace(stretch, deferred=False), 2),
    ]
    frames += [(f"1080p {n} taps", c3f, dataclasses.replace(
        settings, aniso_taps=n), 0) for n in NEW_TAPS]
    frames += [
        ("720p cubes mip-block", c2f, c2_settings, None),
        ("720p cubes 2 taps", c2f, dataclasses.replace(c2_settings,
                                                       aniso_taps=2), 6),
        ("720p cubes MaterialTextures", c2f[:1] + (c2_textures,) + c2f[2:],
         c2_settings, 6),
        ("1080p shadows", c3f, shadowed, None),
        ("1080p (T, 3)", svf, dataclasses.replace(settings, **legacy), 0),
        ("1080p (T, 3) shadows", svf,
         dataclasses.replace(shadowed, **legacy), 9),
        ("1080p (T, 3) TBN", svf,
         dataclasses.replace(settings, show_tbn=True, **legacy), 10),
        ("1080p MeshScene", (mesh_scene, mats, overlay, vb, None),
         mesh_settings, None),
    ]

    def render(i, kernels=KERNELS):
        _, (sc, m, ov, v, pr), s, _ = frames[i]
        return render_frame(sc, v, fp, m, ov, s, ibl=pr, kernels=kernels)

    captured = []
    for i in range(len(frames)):
        captured.append({})
        render(i, capture_kernels(KERNELS, captured[-1]))
    torch.cuda.synchronize()
    # The launch each kernel's timed row takes: K1 on the (T, 3) main and
    # shadow passes, K2 forward, K5 forward + IBL, K6 / K7 at 4 taps, K8 on
    # the cubes at 2 taps.
    kres = check_new_path_launches(captured, dict(
        raster=10, raster_shadow_pass=11, shade=1, shade_gbuffer=3,
        sample_block=5, sample_small=5, sample_mip_block=7))
    for k, v in kres.items():
        print(f"kernel {k} (new paths): " + json.dumps(v))
    del captured

    counters = {"raster": fused.raster_tiles, "sort": sort_keys,
                "overlay": fused.overlay_tiles, "shade": shade_sampled,
                "shade_gbuffer": shade_tonemap,
                "sample_block": tq.sample_table_block_kernel,
                "sample_small": tq.sample_rows_small,
                "sample_mip_block": tq.sample_mip_block_kernel}
    shadow = shadow_fields()
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
    for fn in counters.values():
        fn.launches = 0
    outs, frame_ms, per_frame = [], [], []
    for i in range(len(frames)):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render(i, counted)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((out, cover[0]))
        cover.clear()
        per_frame.append({k: fn.launches - before[k]
                          for k, fn in counters.items()
                          if fn.launches > before[k]})
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["raster"] -= shadow_launches[0]
    launches["raster_shadow_pass"] = shadow_launches[0]
    print("new-path launches: " + json.dumps(launches))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "new-path frames")
    for i, (label, _, s, _) in enumerate(frames):
        want = {"shade": not s.deferred and not s.enable_ibl
                and s.aniso_taps == 1 and label.startswith("1080p forward"),
                "shade_gbuffer": s.aniso_taps > 1 or s.enable_ibl
                or "MaterialTextures" in label}
        for k, on in want.items():
            if on and k not in per_frame[i]:
                raise AssertionError(f"{label}: {k} not launched")
        if s.aniso_taps > 1:
            taps = {"sample_block": s.aniso_taps, "sample_small":
                    s.aniso_taps} if "cubes" not in label else {
                "sample_mip_block": s.aniso_taps,
                "sample_small": s.aniso_taps}
            if any(per_frame[i].get(k) != n for k, n in taps.items()):
                raise AssertionError(f"{label}: sampler launches "
                                     f"{per_frame[i]}, want {taps}")
            if "shade" in per_frame[i]:
                raise AssertionError(f"{label}: K2 launched at "
                                     f"{s.aniso_taps} taps")

    profiles = []
    for i, ((out, cov), (label, (sc, *_), s, twin)) in enumerate(
            zip(outs, frames)):
        ref = render(i, PLAIN)["image"]
        summary = check_frame(i, out, cov, ref,
                              (s.height, s.width, 3), "new-path")
        prof = device_profile(lambda i=i: render(i), reps=3)
        profiles.append(prof)
        line = (f"new-path frame {i}: {label}, {frame_ms[i]:.2f} ms host, "
                f"device {prof['device_ms']:.4f} ms, "
                f"{prof['launches']:.0f} launches, kernels "
                f"{json.dumps(per_frame[i])}")
        if twin is not None:
            line += (f"; twin {frames[twin][0]}: device "
                     f"{profiles[twin]['device_ms']:.4f} ms, "
                     f"{profiles[twin]['launches']:.0f} launches")
        print(line + "; " + summary + f" ({name}, {smi})")
    if torch.equal(outs[1][0]["image"], outs[0][0]["image"]):
        raise AssertionError("the forward frame equals the deferred frame")
    if not torch.equal(outs[10][0]["image"], outs[0][0]["image"]):
        raise AssertionError("the (T, 3) frame differs from the planar "
                             "frame of the same triangles")
    return kres, launches, len(frames)


# The host phase (run_host): the stand-in resource root's session script.
HOST_SIZE = (1920, 1080)
HOST_SCRIPT = [
    {"frame": 2, "key": "w", "down": True},
    {"frame": 8, "key": "w", "down": False},
    {"frame": 10, "mouse": True, "cursor": [0, 0]},
    {"frame": 11, "cursor": [12, 3]},
    {"frame": 12, "cursor": [30, 8]},
    {"frame": 13, "cursor": [44, 10]},
    {"frame": 14, "mouse": False},
    {"frame": 18, "set": {"selected_material": 0}},
    {"frame": 22, "set": {"exposure": 2.0}},
    {"frame": 24, "set": {"enable_tbn": True}},
    {"frame": 27, "set": {"enable_tbn": False}},
    {"frame": 28, "set": {"show_hud": True}},
    {"frame": 32, "set": {"show_hud": False}},
    {"frame": 34, "set": {"size": [1280, 720]}},
    {"frame": 40, "set": {"scene": "gizmo"}},
    {"frame": 48, "set": {"scene": "cube"}},
]
HOST_FRAMES = 58
# The session's first pose: 4 units behind the origin and 0.5 up, so
# that the ball and the point light at (0, 2, 0) are in view (K4
# composites its sphere in frame 0, whose kernels are checked).
HOST_CAMERA = (0.0, 0.5, -4.0)
# Frames held against a direct render_frame: 1080p while moving, the
# material switch, the HUD, the 720p cubes.
HOST_CHECKED = (5, 20, 30, 52)
READBACK_FRAMES = 50
# The CLI frames' per-tile capacity (CAPS' 1080p value; the app's
# default capacities are bench.py's, not autotuned).
HOST_MAX_CANDIDATES = 512


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by Kernels field."""
    from bibim_tpu_torch.pipeline import KERNELS, Kernels

    return dict(zip(Kernels._fields, KERNELS))


def reset_counters() -> None:
    from bibim_tpu_torch.ops.sort import sort_keys

    for fn in kernel_counters().values():
        fn.launches = 0
    sort_keys.device_launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()
            if fn.launches}


class record_frames:
    """Within the block, every ``render_frame`` call the host module
    ``module`` makes goes through ``hook(i, args, kw, out)`` (``i`` the
    call's index); ``first`` = (kernels, context manager) renders call 0
    with those kernels inside that context (capture_kernels /
    capture_composites)."""

    def __init__(self, module, hook, first=None):
        self.module, self.hook, self.first = module, hook, first

    def __enter__(self):
        self.fn = fn = self.module.render_frame
        count = [0]

        def run(*args, **kw):
            i = count[0]
            count[0] += 1
            if i == 0 and self.first is not None:
                kernels, ctx = self.first
                with ctx:
                    out = fn(*args, **dict(kw, kernels=kernels))
            else:
                out = fn(*args, **kw)
            self.hook(i, args, kw, out)
            return out

        self.module.render_frame = run
        return self

    def __exit__(self, *exc):
        self.module.render_frame = self.fn


def host_view_block(cam, width: int, height: int, normal_map: bool, dev,
                    fov: float = 60.0):
    """A ViewBlock built here for the camera pose (the projection on the
    host, as the host modules build it)."""
    import torch

    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import ViewBlock

    return ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=dev),
        proj=m3.perspective(fov, width / height, 0.1, 1000.0,
                            device="cpu").to(dev),
        view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(int(normal_map), dtype=torch.int32,
                                       device=dev))


def host_frame_params(tone_map: bool, exposure: float, dev):
    import torch

    from bibim_tpu_torch.pipeline import FrameParams

    return FrameParams(
        enable_tone_mapping=torch.tensor(int(tone_map), dtype=torch.int32,
                                         device=dev),
        exposure=torch.tensor(exposure, dtype=torch.float32, device=dev))


def run_host_cli(dev, root, mats) -> dict:
    """The CLI on the stand-in root: each frame's PNG against a direct
    render_frame of the same settings and camera (zero drops), then the
    sustained ``--no-write`` loop. Returns ms/frame of that loop."""
    import dataclasses
    import logging

    import numpy as np
    import torch
    from PIL import Image

    from bibim_tpu_torch.host import app
    from bibim_tpu_torch.host.hud import build_hud_geometry, hud_text_mask
    from bibim_tpu_torch.pipeline import make_overlay_resources, render_frame
    from bibim_tpu_torch.utils.validation import check_bin_diag

    w, h = HOST_SIZE
    torus = root / "torus.obj"
    write_torus_obj(torus)
    overlay = make_overlay_resources(device=dev)
    base = ["--size", str(w), str(h), "--max-candidates",
            str(HOST_MAX_CANDIDATES)]
    runs = [("shaderball", ["--scene", "shaderball"]),
            ("forward", ["--scene", "shaderball", "--forward"]),
            ("HUD", ["--scene", "shaderball", "--hud"]),
            ("shadows + IBL", ["--scene", "shaderball", "--shadows",
                               "--ibl"]),
            ("mesh (torus OBJ)", ["--scene", "mesh", "--mesh-path",
                                  str(torus), "--material", "1"])]
    # Every run binds material 1 (the ShaderBall scene's selection), as
    # ``mats`` does.
    ibl = {}
    for label, argv in runs:
        png = root / "cli.png"
        argv = argv + base + ["--out", str(png)]
        reset_counters()
        t0 = time.perf_counter()
        if app.main(argv) != 0:
            raise AssertionError(f"host CLI {label}: exit code not 0")
        host_s = time.perf_counter() - t0
        launches = read_counters()
        got = torch.from_numpy(np.array(Image.open(png).convert("RGB")))
        args = app.build_parser().parse_args(argv)
        scene = app.make_scene(args, dev)
        s = dataclasses.replace(app.frame_settings(args, scene),
                                outputs="image+diag")
        hud = None
        if args.hud:
            geom = build_hud_geometry(w, h)
            text, _ = hud_input(w, h, 0.0, fps=0.0)
            hud = (geom, torch.as_tensor(hud_text_mask(text, geom.max_chars),
                                         device=dev))
        if args.ibl and "sh" not in ibl:
            from bibim_tpu_torch.ops.ibl import make_ibl_sh

            ibl["sh"] = make_ibl_sh(device=dev)
        cam = app.default_camera(args)
        out = render_frame(
            scene.scene_data(), host_view_block(cam, w, h, False, dev),
            host_frame_params(True, 1.0, dev), mats, overlay, s,
            ibl=ibl.get("sh") if args.ibl else None, hud=hud)
        check_bin_diag(out["bin_diag"], where=f"host CLI {label}")
        want = out["image"].cpu()
        if not torch.equal(got, want):
            raise AssertionError(
                f"host CLI {label}: the PNG differs from the direct render "
                f"at {int((got != want).any(dim=-1).sum())} pixels")
        non_bg = float((want != 0).any(dim=-1).float().mean())
        print(f"host CLI {label}: {w}x{h} PNG equal to the direct "
              f"render_frame (non-background {non_bg:.4f}); app.main "
              f"{host_s:.2f} s host with setup; launches "
              + json.dumps(launches))
        if not launches.get("raster"):
            raise AssertionError(f"host CLI {label}: no K1 launch")

    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab()
    logger = logging.getLogger("bibim_tpu_torch")
    logger.addHandler(grab)
    try:
        reset_counters()
        if app.main(["--scene", "shaderball", "--frames", "30", "--orbit",
                     "--no-write"] + base) != 0:
            raise AssertionError("host CLI --no-write: exit code not 0")
    finally:
        logger.removeHandler(grab)
    loop = [ln for ln in lines if ln.startswith("sustained loop:")]
    if not loop:
        raise AssertionError("host CLI --no-write printed no loop line")
    ms = float(loop[-1].split()[2])
    print(f"host CLI --frames 30 --orbit --no-write: {ms:.2f} ms/frame "
          f"(FrameStats over the loop, host clock; syncs on one pixel a "
          f"frame); launches " + json.dumps(read_counters()))
    return {"no_write_ms_per_frame": ms}


def host_syncs(fn) -> list:
    """The host synchronisations the port makes in ``fn`` (torch's sync
    debug mode: one warning per synchronising call), by the innermost
    frame of the port: [(file:line function, count), ...], most first."""
    import traceback
    import warnings

    import torch

    sites: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        port = [f for f in traceback.extract_stack()
                if "bibim_tpu_torch/" in f.filename]
        if port:
            f = port[-1]
            key = (f"{f.filename.split('bibim_tpu_torch/')[-1]}:{f.lineno} "
                   f"{f.name}")
            sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    old = warnings.showwarning
    warnings.showwarning = show
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        warnings.showwarning = old
    torch.cuda.synchronize()
    return sorted(sites.items(), key=lambda kv: -kv[1])


def readback_window(session, depth: int, dev, busy: bool = True) -> dict:
    """``READBACK_FRAMES`` Session.render calls at readback ``depth``:
    median host ms a call, device ms a frame (CUDA events across the
    window) and, with ``busy``, the device's busy share (torch.profiler's
    device time over the wall time of 6 more frames). Every image
    returned equals its frame's ``out["image"].cpu()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bibim_tpu_torch.host import session as session_mod
    from bibim_tpu_torch.host.readback import DoubleBufferedReadback

    session.flush()
    session.readback = DoubleBufferedReadback(depth=depth)
    session.render(1 / 60)  # warm: the pipeline fills
    session.flush()
    images = []
    with record_frames(session_mod,
                       lambda i, a, k, out: images.append(out["image"])):
        returned, host = [], []
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(READBACK_FRAMES):
            t0 = time.perf_counter()
            img = session.render(1 / 60)
            host.append((time.perf_counter() - t0) * 1e3)
            if img is not None:
                returned.append(img)
        b.record()
        returned += session.flush()
        torch.cuda.synchronize()
        device_ms = a.elapsed_time(b) / READBACK_FRAMES
        if len(returned) != len(images):
            raise AssertionError(f"readback depth {depth}: {len(returned)} "
                                 f"images for {len(images)} frames")
        for i, (got, want) in enumerate(zip(returned, images)):
            if not torch.equal(torch.from_numpy(got), want.cpu()):
                raise AssertionError(f"readback depth {depth}: image {i} "
                                     "differs from its frame's output")
    res = dict(depth=depth, frames=READBACK_FRAMES,
               host_ms_median=statistics.median(host),
               host_ms_quartiles=statistics.quantiles(host, n=4),
               device_ms_per_frame=device_ms, images_equal=len(images))
    if busy:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(6):
                session.render(1 / 60)
            session.flush()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        res["busy_share"] = busy_us / 1e3 / wall_ms
    return res


def run_host_viewer(session, dev) -> dict:
    """The live viewer over the 1080p session for a few seconds: a frame
    from /frame.jpg, a W key event moving the camera, /stats, and stop()
    (which raises what ended the render loop, if anything did)."""
    import io
    import urllib.request

    import numpy as np
    from PIL import Image

    from bibim_tpu_torch.host.serve import ViewerServer

    # Loopback requests go straight to the viewer, whatever proxy the
    # environment names.
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    v = ViewerServer(session, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{v.port}"
    try:
        seq, _ = v.wait_for_frame(120)
        jpg = opener.open(url + "/frame.jpg", timeout=60).read()
        shape = np.asarray(Image.open(io.BytesIO(jpg))).shape
        if shape != (HOST_SIZE[1], HOST_SIZE[0], 3):
            raise AssertionError(f"viewer /frame.jpg decodes to {shape}")
        start = session.camera.pos.copy()
        req = urllib.request.Request(
            url + "/event", method="POST",
            data=json.dumps({"key": "w", "down": True}).encode())
        opener.open(req, timeout=60).read()
        seq, _ = v.wait_for_frame(60, after=seq)
        seq, _ = v.wait_for_frame(60, after=seq)
        req = urllib.request.Request(
            url + "/event", method="POST",
            data=json.dumps({"key": "w", "down": False}).encode())
        opener.open(req, timeout=60).read()
        moved = session.camera.pos.copy()
        if not moved[2] > start[2]:
            raise AssertionError(f"viewer: W moved the camera from {start} "
                                 f"to {moved}")
        f0, t0 = v.frames, time.perf_counter()
        time.sleep(2.0)
        served = (v.frames - f0) / (time.perf_counter() - t0)
        stats = json.loads(opener.open(url + "/stats", timeout=60).read())
        if not stats["fps"] > 0:
            raise AssertionError(f"viewer /stats: {stats}")
    finally:
        v.stop()
    if v._render_thread.is_alive():
        raise AssertionError("viewer: the render thread is still alive")
    return dict(served_fps=served, stats=stats, jpeg_bytes=len(jpg),
                camera_moved=[float(x) for x in moved - start])


def run_host(dev, smi: str, name: str):
    """The host slice on a stand-in resource root
    (:func:`write_standin_resources`, 2048² maps) at 1920×1080 on the
    ShaderBall stand-in, deferred, 3 lights: the CLI frames, the Session
    script (counters reset just before it, read just after; its first
    frame's K1-K4 against their plain versions), the readback timings at
    depth 1 and 2 with the host syncs of one frame, and the live viewer.
    Returns (kernel results, launches, frames) of the session script."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import torch

    from bibim_tpu_torch.assets import asset_cache
    from bibim_tpu_torch.host import session as session_mod
    from bibim_tpu_torch.host.gui import UiState
    from bibim_tpu_torch.host.session import Session
    from bibim_tpu_torch.pipeline import (
        KERNELS,
        material_quads_from_set,
        render_frame,
    )
    from bibim_tpu_torch.scene.camera import FreeLookCamera
    from bibim_tpu_torch.utils import config

    old_root, old_cache = config.get_resource_root(), asset_cache.CACHE_DIR
    with tempfile.TemporaryDirectory(prefix="bibim-host-") as tmp:
        root = Path(tmp)
        t0 = t_host = time.perf_counter()
        config.init_resource_root(write_standin_resources(root / "res"))
        asset_cache.CACHE_DIR = root / "cache"
        try:
            print(f"host: stand-in resource root written in "
                  f"{time.perf_counter() - t0:.1f} s (2048² maps)")
            from bibim_tpu_torch.assets.materials import (
                create_pbr_material_set,
            )

            mats = material_quads_from_set(create_pbr_material_set(), 1,
                                           device=dev)
            kinds = sorted(type(t).__name__ for t in mats)
            if kinds != ["BlockTable", "QuadTable"]:
                raise AssertionError(f"host binding {kinds}")
            laps = {"stand-in root": time.perf_counter() - t0}
            t0 = time.perf_counter()
            cli = run_host_cli(dev, root, mats)
            laps["CLI"] = time.perf_counter() - t0

            session = Session(width=HOST_SIZE[0], height=HOST_SIZE[1],
                              ui=UiState(scene="shaderball",
                                         camera_pos=HOST_CAMERA),
                              readback_depth=2)
            if session.readback.depth != 2:
                raise AssertionError("the session's readback is not 2-deep")
            poses, calls, comps = {}, {}, []

            def hook(i, args, kw, out):
                if i in HOST_CHECKED:
                    c = session.camera
                    poses[i] = (c.pos.copy(), c.yaw, c.pitch,
                                dataclasses.replace(session.ui), args, kw)

            t0 = time.perf_counter()
            reset_counters()
            with record_frames(session_mod, hook,
                               (capture_kernels(KERNELS, calls),
                                capture_composites(comps))):
                frames = list(session.run_script(HOST_SCRIPT, HOST_FRAMES))
            torch.cuda.synchronize()
            launches = read_counters()
            script_s = laps["session script"] = time.perf_counter() - t0
            print(f"host session: {len(frames)} frames in {script_s:.2f} s "
                  f"(readback depth 2, autotune included); launches "
                  + json.dumps(launches))
            for k in ("raster", "shade", "sort", "overlay"):
                if not launches.get(k):
                    raise AssertionError(f"host session: kernel {k} was not "
                                         "launched")
            if len(frames) != HOST_FRAMES:
                raise AssertionError(f"host session: {len(frames)} frames")
            resize = next(e["frame"] for e in HOST_SCRIPT
                          if "size" in e.get("set", {}))
            for i, img in enumerate(frames):
                want = ((HOST_SIZE[1], HOST_SIZE[0], 3) if i < resize
                        else (720, 1280, 3))
                if img.shape != want:
                    raise AssertionError(f"host session frame {i}: "
                                         f"{img.shape}, want {want}")
            for i in HOST_CHECKED:
                pos, yaw, pitch, ui, args, kw = poses[i]
                s = args[5]
                cam = FreeLookCamera(pos=pos, yaw=yaw, pitch=pitch)
                out = render_frame(
                    args[0], host_view_block(cam, s.width, s.height,
                                             ui.enable_normal_map, dev),
                    host_frame_params(ui.enable_tone_mapping, ui.exposure,
                                      dev), args[3], args[4], s,
                    hud=kw.get("hud"))
                if not torch.equal(torch.from_numpy(frames[i]),
                                   out["image"].cpu()):
                    raise AssertionError(f"host session frame {i} differs "
                                         "from the direct render_frame")
                print(f"host session frame {i}: {ui.scene} {s.width}x"
                      f"{s.height}, material {ui.selected_material}, hud "
                      f"{s.show_hud}, pose {[round(float(x), 3) for x in pos]}"
                      f" yaw {yaw} pitch {pitch}: equal to the direct "
                      "render_frame")
            print(f"host session retunes: {len(session.retunes)}")
            for key, caps in session.retunes:
                print(f"host retune {key}: " + json.dumps(caps))
            t0 = time.perf_counter()
            kres = check_kernels(calls, comps)
            laps["frame 0 kernel checks"] = time.perf_counter() - t0
            del calls, comps
            for k, v in kres.items():
                print(f"kernel {k} (host session, frame 0): "
                      + json.dumps(v))

            # Readback: back to the 1080p ShaderBall frame.
            session.handle_event({"set": {"scene": "shaderball",
                                          "size": list(HOST_SIZE),
                                          "selected_material": 1,
                                          "exposure": 1.0}})
            t0 = time.perf_counter()
            session.render(1 / 60)  # the retune at the new size
            session.flush()
            syncs = host_syncs(lambda: session.render(1 / 60))
            session.flush()
            print("host syncs of one Session.render (1080p, torch sync "
                  "debug mode): " + json.dumps(syncs))
            # In turns, 1, 2, 2, 1; the busy share on the first of each.
            rb = [readback_window(session, d, dev, busy=i < 2)
                  for i, d in enumerate((1, 2, 2, 1))]
            for r in rb:
                print("host readback: " + json.dumps(r))
            laps["readback"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            session.readback = type(session.readback)(depth=2)
            viewer = run_host_viewer(session, dev)
            print(f"host viewer: {viewer['served_fps']:.2f} fps served at "
                  f"{HOST_SIZE[0]}x{HOST_SIZE[1]} (frames published / "
                  f"wall; {name}, {smi}); " + json.dumps(viewer))
            laps["viewer"] = time.perf_counter() - t0
            summary = dict(cli, readback=rb, served_fps=viewer["served_fps"],
                           retunes=len(session.retunes),
                           host_syncs=sum(n for _, n in syncs),
                           seconds={k: round(v, 1) for k, v in laps.items()})
            print(f"host phase: {time.perf_counter() - t_host:.1f} s; "
                  + json.dumps(summary))
        finally:
            config._active_root = old_root
            asset_cache.CACHE_DIR = old_cache
    return kres, launches, len(frames)


# The sharded frame (run_sharded): config 3 on an in-process mesh of
# SHARDED_BANDS bands (all on cuda:0 with one card, spread over the cards
# with more), the sharded dry run on SHARDED_BANDS bands, and the same
# frame on SHARDED_RANKS ranks over torch.distributed.
SHARDED_BANDS = 4
SHARDED_RANKS = 2
SHARDED_FRAMES = 2  # ShardedRenderer frames on the counted main path
RANK_TIMEOUT_S = 240


def sharded_view(proj, dev):
    """The sharded frames' view: the host phase's first pose
    (:data:`HOST_CAMERA`), where the ball and the point light's sphere at
    (0, 2, 0) are in view, so that a band composites a light sphere."""
    import numpy as np
    import torch

    from bibim_tpu_torch.pipeline import ViewBlock
    from bibim_tpu_torch.scene.camera import FreeLookCamera

    cam = FreeLookCamera(pos=np.asarray(HOST_CAMERA, np.float32))
    return ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=dev),
        proj=proj, view_pos=torch.as_tensor(cam.pos, device=dev),
        enable_normal_map=torch.tensor(0, dtype=torch.int32, device=dev))


def band_raster_stats(calls: list) -> list:
    """Per band, from its main pass's K1 call: slots, live slots (a window
    of at least one candidate), pairs (window rows) and covered tiles."""
    out = []
    for args, _, res in calls:
        idf = res[1][args[11].index("idf")]
        counts = args[6]
        out.append(dict(slots=int(args[4].shape[0]),
                        live_slots=int((counts > 0).sum()),
                        pairs=int(counts.sum()),
                        covered_tiles=int((idf >= 0.5).any(dim=1).sum())))
    return out


def check_band_shades(calls: list, what: str) -> dict:
    """Every band's K2 call against its plain version (its HDR output and
    with the fused tail, :func:`assert_shade_close`); the band with the
    most covered pixels timed."""
    import torch

    from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain

    errs = []
    for args, kw, _ in calls:
        for kwx in (dict(kw, quantize_hdr=False, tonemap=False), kw):
            got = shade_sampled(*args, **kwx)
            want = shade_sampled_plain(*args, **kwx)
            torch.cuda.synchronize()
            errs.append(assert_shade_close(got, want, f"{what} K2"))
    args, kw, _ = max(calls, key=lambda c: int(c[0][6].sum()))
    out = shade_sampled(*args, **kw)
    return dict(max_abs_err=max(errs), checked_calls=len(calls),
                pixels=int(args[1].numel()), library_ms=None,
                **shade_bound(args, kw, out, K2_BLOCK_TAP_CHANNELS),
                **shade_times(shade_sampled, shade_sampled_plain, args, kw,
                              dict(kw, quantize_hdr=False, tonemap=False)))


def check_band_gbuffer_shades(calls: list, what: str) -> dict:
    """Every band's K5 call against its plain version (HDR output, and
    with fp16 + tone map as the frame calls it); the largest timed."""
    import torch

    from bibim_tpu_torch.ops.shading import shade_tonemap, shade_tonemap_plain

    errs = []
    for args, kw, _ in calls:
        for kwx, rel in ((dict(kw, quantize=False, tonemap=False), True),
                         (dict(kw, quantize=True, tonemap=True), False)):
            got = shade_tonemap(*args, **kwx)
            want = shade_tonemap_plain(*args, **kwx)
            torch.cuda.synchronize()
            errs.append(assert_shade_close(got, want, f"{what} K5", rel))
    args, kw, _ = max(calls, key=lambda c: int(c[0][6].sum()))
    hdr_kw = dict(kw, quantize=False, tonemap=False)
    return dict(max_abs_err=max(errs), checked_calls=len(calls),
                pixels=int(args[3].numel()), library_ms=None,
                **shade_bound(args, kw, shade_tonemap(*args, **kw), 0,
                              sampled=False),
                **shade_times(shade_tonemap, shade_tonemap_plain, args, kw,
                              hdr_kw))


def check_band_samplers(calls: list, kern, plain, name: str, taps: int,
                        kernel: str | None = None) -> dict:
    """Every band's sampler call (K6, K7) bit-equal to its plain version;
    the first timed (:func:`check_sampler`)."""
    import torch

    for args, kw, _ in calls[1:]:
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(got[s], want[s]) for s in want):
            raise AssertionError(f"{name}: a band's call differs from its "
                                 "plain version")
    return dict(check_sampler(calls[0], kern, plain, name, taps,
                              kernel=kernel), checked_calls=len(calls))


def check_band_overlays(calls: list, comps: list, what: str) -> dict:
    """Every band's K4 call bit-equal to its plain version; the one with
    the most live slots timed with its launch line (:func:`check_overlay`)."""
    import torch

    from bibim_tpu_torch.ops import fused

    for args, kw, _ in calls:
        work = args[:9] + (args[9].clone(),) + args[10:]
        got = fused.overlay_tiles(*work, **kw)
        want = fused.overlay_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: a band's K4 call differs from "
                                 "its plain version")
    return dict(check_overlay(*overlay_call(calls, comps), what),
                checked_calls=len(calls))


def frame_times(fn, reps: int = 5) -> dict:
    """One frame's host ms (host clock around the call and a synchronize,
    median of ``reps``) and its device ms and kernel launches
    (:func:`device_profile`)."""
    import torch

    prof = device_profile(fn, reps=3)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return dict(host_ms=statistics.median(host), **prof)


def sharded_rank(rank: int, port: int, out_dir: str, frame_settings,
                 band_settings) -> None:
    """One rank of the torch.distributed frame (spawned by
    :func:`run_sharded_ranks`): the config-3 inputs on its card, one
    warm-up frame, then :data:`SHARDED_FRAMES` + 3 timed frames; its image
    and wall ms written to ``out_dir``."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SHARDED_RANKS),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(SHARDED_RANKS))
    import torch
    import torch.distributed as dist

    from bibim_tpu_torch.parallel import (
        make_process_mesh,
        render_frame_sharded,
    )

    mesh = make_process_mesh(init_method=f"tcp://localhost:{port}")
    try:
        dev = mesh.devices[rank]
        scene, mats, overlay, proj, fp, _ = build_inputs(dev, caps=BASE3)
        vb = sharded_view(proj, dev)

        def frame():
            return render_frame_sharded(mesh, scene, vb, fp, mats,
                                        frame_settings, overlay=overlay,
                                        band_settings=band_settings)

        img = frame()
        ms = []
        for _ in range(SHARDED_FRAMES + 3):
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            img = frame()
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.save(img.cpu(), f"{out_dir}/rank{rank}.pt")
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(dict(rank=rank, device=str(dev),
                           backend=dist.get_backend(), wall_ms=ms), f)
    finally:
        dist.destroy_process_group()


def run_sharded_ranks(scene, mats, overlay, fp, vb, base) -> dict:
    """The config-3 frame on :data:`SHARDED_RANKS` spawned ranks, one band
    each (NCCL with a card per rank, else gloo with both on cuda:0): each
    rank's image ``torch.equal`` to the in-process frame of as many bands
    at the same settings. The kernels are built before the spawn."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as tmp_mp

    from bibim_tpu_torch.parallel import (
        make_device_mesh,
        render_frame_sharded,
    )
    from bibim_tpu_torch.pipeline.autotune import autotune_settings_sharded

    frame_s, band_s, _ = autotune_settings_sharded(
        scene, vb, base, SHARDED_RANKS, margin=MARGIN, materials=mats,
        overlay=overlay)
    want = render_frame_sharded(make_device_mesh(SHARDED_RANKS), scene, vb,
                                fp, mats, frame_s, overlay=overlay,
                                band_settings=band_s).cpu()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="bibim-ranks-") as tmp:
        t0 = time.perf_counter()
        ctx = tmp_mp.start_processes(
            sharded_rank, args=(port, tmp, frame_s, band_s),
            nprocs=SHARDED_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            # join raises if a rank failed (and ends the others).
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the ranks did not finish in "
                                         f"{RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in ctx.processes]
        if codes != [0] * SHARDED_RANKS:
            raise AssertionError(f"rank exit codes {codes}")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SHARDED_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
            img = torch.load(f"{tmp}/rank{r}.pt")
            if not torch.equal(img, want):
                raise AssertionError(f"rank {r}'s frame differs from the "
                                     f"in-process {SHARDED_RANKS}-band frame")
    return dict(ranks=ranks, seconds=round(wall, 1),
                equal_to_in_process=True)


def run_sharded_dryrun(dev) -> tuple:
    """``parallel.dryrun.dryrun_multichip`` on :data:`SHARDED_BANDS` bands
    on a stand-in resource root (2048² maps: block tables, so the bands
    sample on K6), with the counters reset just before it and read just
    after; the shadow passes' K1 (counted apart) and every band's K5, K6
    and K7 against their plain versions. Returns (kernel results,
    launches, frames)."""
    import tempfile
    from pathlib import Path

    import torch

    from bibim_tpu_torch.assets import asset_cache
    from bibim_tpu_torch.ops import fused
    from bibim_tpu_torch.ops import texture_quad as tq
    from bibim_tpu_torch.parallel.dryrun import dryrun_multichip
    from bibim_tpu_torch.pipeline import KERNELS
    from bibim_tpu_torch.utils import config

    old_root, old_cache = config.get_resource_root(), asset_cache.CACHE_DIR
    calls: dict = {}
    shadow = shadow_fields()
    shadow_launches = [0]
    cap = capture_kernels(KERNELS, calls)

    def raster_counted(*args, **kw):
        before = fused.raster_tiles.launches
        out = cap.raster(*args, **kw)
        if tuple(args[11]) == shadow:
            shadow_launches[0] += fused.raster_tiles.launches - before
        return out

    with tempfile.TemporaryDirectory(prefix="bibim-dryrun-") as tmp:
        root = Path(tmp)
        config.init_resource_root(write_standin_resources(root / "res"))
        asset_cache.CACHE_DIR = root / "cache"
        try:
            reset_counters()
            t0 = time.perf_counter()
            r, (away, front) = dryrun_multichip(
                SHARDED_BANDS, kernels=cap._replace(raster=raster_counted))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counters()
        finally:
            config._active_root = old_root
            asset_cache.CACHE_DIR = old_cache
    launches["raster_shadow_pass"] = shadow_launches[0]
    print(f"sharded dry run: {SHARDED_BANDS} bands of "
          f"{front.shape[0] // SHARDED_BANDS} rows, {front.shape[1]}x"
          f"{front.shape[0]}, {seconds:.1f} s (stand-in root and tunes "
          f"included); retunes {r.retunes}; launches "
          + json.dumps(launches) + "; band caps "
          + json.dumps({k: getattr(r._band, k) for k in DERIVED_KEYS}))
    for k in ("raster_shadow_pass", "shade_gbuffer", "sample_block",
              "sample_small"):
        if not launches.get(k):
            raise AssertionError(f"sharded dry run: kernel {k} was not "
                                 "launched")
    if not float(front.float().mean()) > float(away.float().mean()):
        raise AssertionError("sharded dry run: the front frame shows less "
                             "than the away frame")
    sh = [c for c in calls["raster"] if tuple(c[0][11]) == shadow]
    kres = {"raster_shadow_pass": check_raster(sh[0], calls=sh[1:]),
            "shade_gbuffer": check_band_gbuffer_shades(
                calls["shade_gbuffer"], "sharded dry run"),
            "sample_block": check_band_samplers(
                calls["sample_block"], tq.sample_table_block_kernel,
                tq.sample_table_block, "sample_block",
                SAMPLER_TAPS["sample_block"], kernel="sample_block_kernel"),
            "sample_small": check_band_samplers(
                calls["sample_small"], tq.sample_rows_small,
                tq.sample_rows_small_plain, "sample_small",
                SAMPLER_TAPS["sample_small"])}
    return kres, launches, 3


def run_sharded(dev, smi: str, name: str):
    """The sharded frame: config 3 (1920×1080 ShaderBall stand-in,
    deferred GGX, 3 lights, light spheres; :func:`build_inputs`) through a
    ``ShardedRenderer`` on :data:`SHARDED_BANDS` in-process bands, tuned
    by ``autotune_settings_sharded(pair_sampling=2, margin=1.05,
    materials=, overlay=)``, its frames with the counters reset just
    before and read just after; every band's K1, K3, K2 and K4 launch of
    the first frame against its plain version; the frame within the
    golden bound of ``render_frame`` on one card at the frame settings,
    drop-free; its device ms, host ms and launches beside the single-card
    frame's; then the dry run (:func:`run_sharded_dryrun`) and the
    torch.distributed frame (:func:`run_sharded_ranks`). Returns (kernel
    results, launches, frames) of the config-3 frames and of the dry
    run."""
    import dataclasses

    import torch

    from bibim_tpu_torch.parallel import (
        ShardedRenderer,
        make_device_mesh,
        render_frame_sharded,
    )
    from bibim_tpu_torch.pipeline import KERNELS, render_frame
    from bibim_tpu_torch.pipeline.autotune import band_height
    from bibim_tpu_torch.utils.validation import check_bin_diag

    t_phase = time.perf_counter()
    scene, mats, overlay, proj, fp, base = build_inputs(dev, caps=BASE3)
    vb = sharded_view(proj, dev)
    mesh = make_device_mesh(SHARDED_BANDS)
    r = ShardedRenderer(mesh, base, mats, overlay=overlay, margin=MARGIN)
    reset_counters()
    t0 = time.perf_counter()
    imgs = [r.render(scene, vb, fp) for _ in range(SHARDED_FRAMES)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counters()
    if r.retunes != 1:
        raise AssertionError(f"sharded 1080p: {r.retunes} tunes (a frame "
                             "dropped geometry)")
    for k in ("raster", "shade", "sort", "overlay"):
        if not launches.get(k):
            raise AssertionError(f"sharded 1080p: kernel {k} was not "
                                 "launched")
    band_h = band_height(base, SHARDED_BANDS)
    print(f"sharded 1080p: {SHARDED_BANDS} bands of {band_h} rows on "
          f"{sorted({str(d) for d in mesh.devices})}; {SHARDED_FRAMES} "
          f"frames in {first_s:.2f} s (tune included); launches "
          + json.dumps(launches))
    print("sharded 1080p caps (frame, band): " + json.dumps(
        {k: [getattr(r._frame, k), getattr(r._band, k)]
         for k in DERIVED_KEYS}))

    calls: dict = {}
    comps: list = []
    with capture_composites(comps):
        img, diag = render_frame_sharded(
            mesh, scene, vb, fp, mats, r._frame, overlay=overlay,
            band_settings=r._band, return_diag=True,
            kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    check_bin_diag(diag, where="sharded 1080p frame")
    if not all(torch.equal(img, x) for x in imgs):
        raise AssertionError("sharded 1080p: the captured frame differs "
                             "from the renderer's frames")
    for k, n_k in (("raster", 1), ("shade", 1), ("overlay", 1)):
        if len(calls.get(k, ())) != SHARDED_BANDS * n_k:
            raise AssertionError(f"sharded 1080p: {len(calls.get(k, ()))} "
                                 f"{k} calls for {SHARDED_BANDS} bands")
    for b, st in enumerate(band_raster_stats(calls["raster"])):
        print(f"sharded 1080p band {b}: rows {b * band_h}-"
              f"{(b + 1) * band_h - 1}, K1 " + json.dumps(st))
    # K1 timed on the band with the most window rows.
    k1 = sorted(calls["raster"], key=lambda c: -int(c[0][6].sum()))
    kres = {"raster": check_raster(k1[0], calls=k1[1:]),
            "sort": check_sorts(calls["sort"]),
            "shade": check_band_shades(calls["shade"], "sharded 1080p"),
            "overlay": check_band_overlays(calls["overlay"], comps,
                                           "sharded 1080p light spheres")}
    del calls, comps
    for k, v in kres.items():
        print(f"kernel {k} (sharded 1080p, {SHARDED_BANDS} bands): "
              + json.dumps(v))

    single_s = dataclasses.replace(r._frame, outputs="image+diag")
    single = render_frame(scene, vb, fp, mats, overlay, single_s)
    check_bin_diag(single["bin_diag"], where="single-card 1080p frame")
    assert_golden_bound(img, single["image"],
                        "sharded 1080p frame vs the single-card frame")
    same = float((img == single["image"]).all(dim=-1).float().mean())
    times = {
        "sharded": frame_times(lambda: render_frame_sharded(
            mesh, scene, vb, fp, mats, r._frame, overlay=overlay,
            band_settings=r._band)),
        "single": frame_times(lambda: render_frame(
            scene, vb, fp, mats, overlay,
            dataclasses.replace(r._frame, outputs="image"))),
    }
    print(f"sharded 1080p frame: identical to the single-card frame "
          f"{same:.6f} (golden bound held, drop-free); times ({name}, "
          f"{smi}): " + json.dumps(times))

    kres_d, launches_d, n_d = run_sharded_dryrun(dev)
    for k, v in kres_d.items():
        print(f"kernel {k} (sharded dry run): " + json.dumps(v))
    ranks = run_sharded_ranks(scene, mats, overlay, fp, vb, base)
    print(f"sharded ranks ({SHARDED_RANKS}, {name}, {smi}): "
          + json.dumps(ranks))
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return (kres, launches, SHARDED_FRAMES), (kres_d, launches_d, n_d)



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
    PTXAS.update(usage)
    print("ptxas usage: " + json.dumps(usage))
    for what, prefixes, least in (
            ("K2 / K5", ("shade_kernel", "gbuffer_shade_kernel"), 4),
            ("K6", ("sample_block_kernel", "sample_block_pair_kernel"), 9),
            ("K9 / K11", ("raster_earlyz_kernel", "raster_fine_kernel"), 8),
            ("K4 / K8 / K10", ("overlay_kernel", "mip_block_kernel",
                               "raster_gw_kernel"), 18)):
        kern = {k: v for k, v in usage.items() if k.startswith(prefixes)}
        if len(kern) < least or any(
                v.get("stack", 1) or v.get("spill_stores", 1)
                or v.get("spill_loads", 1) for v in kern.values()):
            raise AssertionError(f"{what} instantiations must have a 0-byte "
                                 "stack frame and no spills: "
                                 + json.dumps(kern))

    kres1, launches1 = run_config1(dev, smi, name)

    scene, mats, overlay, proj, fp, base = build_inputs(dev, caps=BASE3)
    t = sum(int(b.positions.shape[0]) // 3 * int(b.model.shape[0])
            for b in scene.batches)
    print(f"smoke frame: {WIDTH}x{HEIGHT}, {t} triangles, lights "
          f"{scene.lights.num_lights}, materials "
          f"{[(type(m).__name__, m.height, m.width) for m in mats]}; gizmo "
          "off: gizmo.obj is not in the repository")
    vbs = [view_block(y, proj, dev) for y in YAWS]
    yaw_settings = [derive(scene, vb, base, mats, overlay, f"1080p yaw {y}")
                    for y, vb in zip(YAWS, vbs)]
    settings = yaw_settings[0]

    # Kernel phases on the inputs the smoke frames produce.
    calls: dict = {}
    comps: list = []
    with capture_composites(comps):
        for vb, s in zip(vbs, yaw_settings):
            render_frame(scene, vb, fp, mats, overlay, s,
                         kernels=capture_kernels(KERNELS, calls))
    torch.cuda.synchronize()
    kres = check_kernels(calls, comps)
    k1_yaw0 = calls["raster"][0]  # the default frame of the K10 view
    del calls, comps

    # The group-window frame: group_pair_cap from the port's probe of the
    # first view (derive_settings' rule), the other capacities as above.
    vb0 = vbs[0]
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
    args, kw, out = calls["raster_gw"][0]
    print("config-3 K10 launch: " + json.dumps(k10_launch(
        args, kw, out, -(-gw_cap // 8) * 8, k1_yaw0)))
    del calls, k1_yaw0

    # The HUD frame: the first view with the app's stats line burned in
    # by K4 against a cleared key, after the light spheres.
    hud_text, hud = hud_input(WIDTH, HEIGHT, YAWS[0])
    settings_hud = dataclasses.replace(settings, show_hud=True)
    print(f"HUD frame: yaw {YAWS[0]}, {hud[0].max_chars} characters at "
          f"scale 2, text {hud_text!r}")
    calls, comps = {}, []
    with capture_composites(comps):
        render_frame(scene, vb0, fp, mats, overlay, settings_hud,
                     kernels=capture_kernels(KERNELS, calls), hud=hud)
    torch.cuda.synchronize()
    kres_hud = check_overlay(*overlay_call(calls["overlay"], comps, -1),
                             "config-3 HUD")
    del calls, comps
    for k, v in [*kres.items(), ("overlay (HUD)", kres_hud)]:
        print(f"kernel {k}: " + json.dumps(v))

    # Main path: counters to 0, the four frames through render_frame; then
    # counters to 0 again and the group-window frame in its own window;
    # then the HUD frame in a third.
    frames = [(f"yaw {y}", vb, s, None)
              for y, vb, s in zip(YAWS, vbs, yaw_settings)]
    frames.append((f"yaw {YAWS[0]}, group window", vb0, settings_gw, None))
    frames.append((f"yaw {YAWS[0]}, HUD", vb0, settings_hud, hud))
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
    n = len(YAWS)
    for window in (frames[:n], frames[n:n + 1], frames[n + 1:]):
        for fn in counters.values():
            fn.launches = 0
        sort_keys.device_launches = 0
        for _, vb, s, h in window:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_frame(scene, vb, fp, mats, overlay, s,
                               kernels=counted, hud=h)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append((out, cover[-1]))
        windows.append({k: fn.launches for k, fn in counters.items()})
        print(k3_device_line(f"1080p main path ({len(window)} frames):"))
    launches = dict(windows[0], raster_gw=windows[1]["raster_gw"])
    print(f"main-path launches ({len(YAWS)} frames): "
          + json.dumps(windows[0]))
    print("group-window frame launches (1 frame): " + json.dumps(windows[1]))
    print("HUD frame launches (1 frame): " + json.dumps(windows[2]))
    for k, n_k in [*launches.items(), ("overlay (HUD frame)",
                                       windows[2]["overlay"])]:
        if n_k <= 0:
            raise AssertionError(f"kernel {k} was not launched by the frame")

    for i, ((out, cov_i), (label, vb, s, h)) in enumerate(zip(outs,
                                                              frames)):
        ref = render_frame(scene, vb, fp, mats, overlay, s, kernels=PLAIN,
                           hud=h)["image"]
        summary = check_frame(i, out, cov_i, ref, (HEIGHT, WIDTH, 3),
                              "1080p")
        print(f"frame {i}: {label}, {frame_ms[i]:.2f} ms, " + summary)
    if not torch.equal(outs[n][0]["image"], outs[0][0]["image"]):
        raise AssertionError("the group-window frame differs from the "
                             "default frame of its yaw")
    print("HUD frame: " + check_hud_frame(outs[-1][0]["image"],
                                          outs[0][0]["image"], hud[0]))
    print(f"frame time median: {statistics.median(frame_ms[:n]):.2f}"
          f" ms (host clock around render_frame + synchronize, {name}, "
          f"{smi}); group-window frame {frame_ms[n]:.2f} ms, HUD frame "
          f"{frame_ms[-1]:.2f} ms")
    del outs

    kres5, launches5, c5 = run_config5(dev, smi, name)
    kres_p, launches_p = run_pair_paths(
        dev, smi, name, (scene, mats, overlay, proj, fp, base, settings), c5)
    kres2, launches2 = run_config2(dev, smi, name)
    kres4, launches4 = run_config4(dev, smi, name)
    kres_n, launches_n, n_new = run_new_paths(
        dev, smi, name, (scene, mats, overlay, proj, fp, base, settings))
    kres_h, launches_h, n_host = run_host(dev, smi, name)
    (kres_s, launches_s, n_s), (kres_d, launches_d, n_d) = run_sharded(
        dev, smi, name)

    # One row per kernel and path: K1 and K3 on the config-1 frame, K1-K4
    # on the 1080p path's 4 frames, K10 on its group-window frame, every
    # kernel the config-5 path runs (K1 twice: main and shadow pass), K2
    # and K6 at pair level 2 on the pair-path frames that launch them (their
    # pair launches: K2 on the routed close-up and the 1080p lossy frame,
    # K6 on the config-5 lossy frame),
    # every kernel of the config-2 path (K2 with the mip groups, K8, K7
    # routed), then the config-4 path (K1, its tail, K3, K2, K9, K11).
    # ``frames``: the main-path frames its launches count.
    n2, n4 = len(C2_CAMERA_Z) + len(C2_VIEWS), len(C4_VIEWS) * len(C4_MODES)
    rows = [(k, KERNEL_INFO[k][0] + ", config-1 512² flat", kres1[k],
             launches1[k], 1) for k in kres1]
    rows += [(k, KERNEL_INFO[k][0] + ", 1080p", kres[k], launches[k],
              1 if k == "raster_gw" else len(YAWS)) for k in kres]
    rows.append(("overlay", KERNEL_INFO["overlay"][0] + ", 1080p HUD frame",
                 kres_hud, windows[2]["overlay"], 1))
    rows += [(k, KERNEL_INFO[k][0] + ", config-5 4K", kres5[k],
              launches5[k], len(C5_YAWS)) for k in kres5 if k in KERNEL_INFO]
    rows.append(("raster", KERNEL_INFO["raster"][0]
                 + ", config-5 shadow pass", kres5["raster_shadow_pass"],
                 launches5["raster_shadow_pass"], len(C5_YAWS)))
    rows.append(("shade", KERNEL_INFO["shade"][0] + ", pair level 2: "
                 "routed close-up clean tiles and 1080p pair_lossy",
                 kres_p["shade_pair"], launches_p["shade_pair"], 2))
    rows.append(("sample_block", KERNEL_INFO["sample_block"][0]
                 + ", pair level 2: config-5 pair_lossy",
                 kres_p["sample_block_pair"],
                 launches_p["sample_block_pair"], 1))
    rows += [(k, KERNEL_INFO[k][0] + ", config-2 720p cubes", kres2[k],
              launches2[k], n2) for k in kres2]
    rows += [(k, KERNEL_INFO[k][0] + (", tail" if k == "raster_tail"
                                      else "") + ", config-4 1080p x64",
              kres4[k], launches4[k], n4) for k in kres4]
    new_paths = {
        "raster": "new paths: main passes (forward, taps, (T, 3), TBN, "
                  "MeshScene, cubes)",
        "raster_shadow_pass": "new paths: shadow passes (planar and (T, 3))",
        "shade": "forward 1080p, quantize=False",
        "shade_gbuffer": "new paths: forward + IBL, taps, MaterialTextures",
        "sample_block": f"new paths: 1080p at {NEW_TAPS} taps, forward + IBL",
        "sample_small": "new paths: 1080p and cubes at 2-4 taps",
        "sample_mip_block": "new paths: 720p cubes at 2 taps"}
    rows += [("raster" if k == "raster_shadow_pass" else k,
              KERNEL_INFO["raster" if k == "raster_shadow_pass" else k][0]
              + ", " + label, kres_n[k], launches_n[k], n_new)
             for k, label in new_paths.items()]
    rows += [(k, KERNEL_INFO[k][0] + ", host Session script (1080p / "
              "720p, frame 0 checked)", kres_h[k], launches_h[k], n_host)
             for k in ("raster", "shade", "sort", "overlay")]
    rows += [(k, KERNEL_INFO[k][0] + f", sharded 1080p ({SHARDED_BANDS} "
              "bands)", kres_s[k], launches_s[k], n_s)
             for k in ("raster", "shade", "sort", "overlay")]
    rows.append(("raster", KERNEL_INFO["raster"][0] + ", sharded dry run: "
                 "shadow passes", kres_d["raster_shadow_pass"],
                 launches_d["raster_shadow_pass"], n_d))
    rows += [(k, KERNEL_INFO[k][0] + ", sharded dry run", kres_d[k],
              launches_d[k], n_d)
             for k in ("shade_gbuffer", "sample_block", "sample_small")]
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
