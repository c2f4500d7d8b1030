"""The plain reference against the program's all-plain frame (the
``Session`` on the CPU, where every kernel runs its plain version) on the
same stand-in inputs, one pose of each configuration at a small size; and
the bfloat16 control, which must fail the configuration's limits.

The shadow-map and IBL reference (``reference/shadow_ibl.py``, BASELINE
config 5's frame) against the program's ``render_frame`` with shadows and
IBL on, on the CPU at a small size, where its control and each of its
planted faults must fail the limits too; and on the card at 3840 × 2160
over poses of the orbit mix, the readings the limits of a cell of that
frame are set from."""

import json

import numpy as np
import pytest
import torch

from h100_bench import camera_paths, check, harness
from h100_bench.drivers import viewer
from h100_bench.tests.conftest import BENCH, small_cell

# (config, pose, width, height): the ball and both light spheres from
# above; the 64-ball row broadside from 62 units, every ball in view.
CASES = [
    ("shaderball_1080p", ((3.0, 1.0, -3.0), 40.0, -20.0), 256, 144),
    ("shaderball64_1080p", ((63.0, 15.047, -57.888), 0.0, -15.0), 256, 144),
]
SEED = 2**31 + 11
# BASELINE config 5 (bench.py bench_stretch_4k) as settings over the
# one-ball configuration: a 1024² map of the directional light fit to the
# ball, bias 2e-3, and the IBL ambient.
SHADOW_IBL = {"reference": "shadow_ibl", "shadows": True, "shadow_size": 1024,
              "shadow_bias": 2e-3, "shadow_light": 0, "ibl": True}
# The ball's shadow on the plane in view beside the ball (the orbit pose
# 6 units from (0, 0, 2) at yaw 45°, pitch −30°); the ball and both light
# spheres from above.
SHADOW_IBL_CASES = [
    ("shaderball_1080p", ((3.6742349, 3.0, -1.6742349), 45.0, -30.0), 256,
     144, SHADOW_IBL),
    ("shaderball_1080p", ((3.0, 1.0, -3.0), 40.0, -20.0), 256, 144,
     SHADOW_IBL),
]


def render_pair(cell, pose, device, dtype=torch.float32):
    root = harness.prepare_resources(cell.config, SEED)
    session = viewer.make_session(cell.config, cell.traffic, device)
    viewer.set_pose(session, pose)
    session.render()
    session.flush()  # the tune at this pose
    session.render()
    got = session.flush()[-1]
    ref = harness.make_reference(cell.config, root, device)
    want = ref.render(*pose).cpu().numpy()
    low = harness.make_reference(cell.config, root, device, dtype)
    return got, want, low.render(*pose).cpu().numpy()


def config5_frames(config: dict, poses, device) -> list:
    """The program's frames of ``poses`` with BASELINE config 5's settings
    (bench.py bench_stretch_4k: shadows fit to the balls, the analytic
    IBL probe, span cap 32, pair sampling 2) at ``config``'s size and
    shadow settings, each autotuned at its pose with margin 1.05; the
    resources those :func:`harness.prepare_resources` last pointed at."""
    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.assets.materials import create_pbr_material_set
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.pipeline import (
        FrameParams,
        RenderSettings,
        ViewBlock,
        make_overlay_resources,
        material_quads_from_set,
        render_frame,
    )
    from bibim_tpu_torch.pipeline.autotune import autotune_settings
    from bibim_tpu_torch.scene.camera import FreeLookCamera
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    w, h = config["width"], config["height"]
    scene = ShaderBallScene(num_instances=config["num_instances"],
                            device=device)
    mats = material_quads_from_set(create_pbr_material_set(),
                                   config["material_index"], device=device)
    overlay = make_overlay_resources(device=device)
    ibl = make_ibl_sh(device=device)
    # The projection on the host, uploaded, as the viewer and the CLI
    # build it.
    proj = m3.perspective(60.0, w / h, 0.1, 1000.0, device="cpu").to(device)
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(int(config["tone_map"]),
                                         dtype=torch.int32, device=device),
        exposure=torch.tensor(config["exposure"], device=device))
    base = RenderSettings(
        width=w, height=h, outputs="image", enable_shadows=True,
        enable_ibl=True, span_cap=32, pair_sampling=2,
        shadow_fit_batches=scene.shadow_fit_batches,
        shadow_size=config["shadow_size"], shadow_bias=config["shadow_bias"],
        shadow_light=config["shadow_light"])
    out = []
    for pos, yaw, pitch in poses:
        cam = FreeLookCamera()
        cam.pos = np.asarray(pos, np.float32)
        cam.yaw, cam.pitch = float(yaw), float(pitch)
        vb = ViewBlock(
            view=torch.as_tensor(cam.get_view_matrix(), device=device),
            proj=proj, view_pos=torch.as_tensor(cam.pos, device=device),
            enable_normal_map=torch.tensor(0, dtype=torch.int32,
                                           device=device))
        data = scene.scene_data()
        settings, _ = autotune_settings(data, vb, base, margin=1.05,
                                        materials=mats, overlay=overlay)
        with torch.no_grad():
            img = render_frame(data, vb, fp, mats, overlay, settings,
                               ibl=ibl)["image"]
        out.append(img.cpu().numpy())
    return out


@pytest.mark.parametrize(
    "config,pose,width,height,over",
    [c + (None,) for c in CASES] + SHADOW_IBL_CASES,
    ids=[c[0] for c in CASES] + ["shadow_ibl-shadow", "shadow_ibl-spheres"])
def test_reference_matches_plain_frame(tmp_path, config, pose, width,
                                       height, over):
    cell = small_cell(tmp_path, config, "orbit", width, height,
                      config_over=over)
    if over is None:
        got, want, low = render_pair(cell, pose, "cpu", torch.bfloat16)
    else:
        root = harness.prepare_resources(cell.config, SEED)
        (got,) = config5_frames(cell.config, [pose], "cpu")
        want, mask = harness.reference_frame(harness.make_reference(
            cell.config, root, "cpu", dirs=cell.dirs), pose)
        low = harness.make_reference(cell.config, root, "cpu",
                                     torch.bfloat16, dirs=cell.dirs)
        low = low.render(*pose).cpu().numpy()
    limits = cell.config["limits"]
    r = check.frame_readings(got, want)
    assert (got.max(-1) > 0).mean() > 0.05  # something was drawn
    assert all(r[k] <= limits[k] for k in limits), r
    if cell.config["num_instances"] == 1:
        # One ball: the plain kernels and the reference round alike.
        assert np.array_equal(got, want)
    c = check.frame_readings(low, want)
    assert any(c[k] > limits[k] for k in limits), c
    if over is not None:
        # Each fault planted in the reference fails the limits.
        faults = harness.reference_module(cell.config, cell.dirs).FAULTS
        assert set(faults) == {"overlays", "shadows", "ibl"}
        for name, settings in faults.items():
            bad = harness.make_reference(dict(cell.config, **settings),
                                         root, "cpu", dirs=cell.dirs)
            r = check.frame_readings(bad.render(*pose).cpu().numpy(), want,
                                     mask)
            assert any(r[k] > limits[k] for k in limits), (name, r)


@pytest.mark.cuda
def test_reference_matches_kernels_on_the_card(tmp_path, cuda_device):
    config, pose, width, height = CASES[0]
    cell = small_cell(tmp_path, config, "orbit", 1920, 1080)
    got, want, low = render_pair(cell, pose, cuda_device, torch.bfloat16)
    limits = cell.config["limits"]
    r = check.frame_readings(got, want)
    assert all(r[k] <= limits[k] for k in limits), r
    c = check.frame_readings(low, want)
    assert any(c[k] > limits[k] for k in limits), c


# The card readings of config 5's frame: three seeds of the orbit mix
# (each its own stand-in set), twelve poses of each (as many frames as a
# run compares), one a segment of the path.
CARD_SEEDS = (2**31 + 1001, 2**31 + 1002, 2**31 + 1003)
CARD_FRAMES = range(0, 360, 30)


@pytest.mark.cuda
def test_shadow_ibl_readings_on_the_card(cuda_device):
    """The program's config-5 frame at 3840 × 2160 against the shadow/IBL
    reference over orbit poses; the bfloat16 control and each planted
    fault (and a 16 × 16 block inverted) against the same reference. A
    seed's reading is the worst over its poses, as a run's is over its
    frames; every control and fault reading lies above every program
    reading in at least one number. A fault that left every frame of a
    seed within the tolerance (the ball's shadow out of view at all its
    poses) planted nothing there and is reported, not held. Prints each
    pose's and each seed's readings as JSON lines ("readings: ...")."""
    from h100_bench.control import inverted_block

    config = json.loads((BENCH / "configs" / "shaderball_1080p.json")
                        .read_text())
    config.update(SHADOW_IBL, name="shaderball_4k_shadow_ibl", width=3840,
                  height=2160)
    traffic = json.loads((BENCH / "traffic" / "orbit.json").read_text())
    params = camera_paths.merged_params(traffic["path"], config)
    planted = harness.reference_module(config).FAULTS
    sides = ["program", "control", *planted, "block"]
    seeds = {side: [] for side in sides}
    for seed in CARD_SEEDS:
        root = harness.prepare_resources(config, seed)
        path = camera_paths.CameraPath(params, seed)
        poses = [path.pose(i) for i in CARD_FRAMES]
        got = config5_frames(config, poses, cuda_device)
        refs = {"control": harness.make_reference(config, root, cuda_device,
                                                  torch.bfloat16)}
        refs.update({name: harness.make_reference(dict(config, **over),
                                                  root, cuda_device)
                     for name, over in planted.items()})
        ref = harness.make_reference(config, root, cuda_device)
        worst = {side: dict.fromkeys(check.NAMES, 0.0) for side in sides}
        for pose, img in zip(poses, got):
            with torch.no_grad():
                want, mask = harness.reference_frame(ref, pose)
                frames = {"program": img, "block": inverted_block(want)}
                frames.update({name: harness.reference_frame(r, pose)[0]
                               for name, r in refs.items()})
            for side in sides:
                r = check.frame_readings(frames[side], want, mask)
                print("readings: " + json.dumps(
                    {"seed": seed, "pose": pose, "side": side, **r}))
                worst[side] = {k: max(v, r[k])
                               for k, v in worst[side].items()}
        for side in sides:
            print("readings: " + json.dumps(
                {"seed": seed, "side": side, "worst": worst[side]}))
            seeds[side].append(worst[side])
        del refs, ref
        torch.cuda.empty_cache()
    program_max = {k: max(r[k] for r in seeds["program"])
                   for k in check.NAMES}
    print("readings: " + json.dumps({"program_max": program_max, **{
        f"{side}_min": {k: min(r[k] for r in seeds[side])
                        for k in check.NAMES} for side in sides[1:]}}))
    for side in sides[1:]:
        for seed, r in zip(CARD_SEEDS, seeds[side]):
            if not any(r.values()):
                print("readings: " + json.dumps(
                    {"seed": seed, "side": side, "planted": False}))
                continue
            assert any(r[k] > program_max[k] for k in check.NAMES), \
                (side, r, program_max)
