"""The port's interactive Session on the CPU (device="cpu"), on the
stand-in resource root (chip_smoke.write_standin_resources): the live-loop
behaviours of tests/test_session.py, every session frame against the
port's own render_frame at the session's pose and settings, and the
session against the JAX package's Session on one script — the camera pose,
the retuned caps field for field, and a frame within the golden bound."""

import inspect

import numpy as np
import pytest
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.host.gui import UiState
from bibim_tpu_torch.host.session import Session, merge_caps
from bibim_tpu_torch.pipeline import (
    FrameParams,
    ViewBlock,
    material_quads_from_set,
    render_frame,
)
from tests import torch_port_cases as cases

W, H = 128, 64
# The script both packages' sessions replay (frames of 0.1 s): W held for
# two frames, then a drag, then the exposure raised.
SCRIPT = [
    {"frame": 1, "key": "w", "down": True},
    {"frame": 3, "key": "w", "down": False},
    {"frame": 3, "mouse": True, "cursor": [0, 0]},
    {"frame": 4, "cursor": [30, -10]},
    {"frame": 5, "mouse": False, "set": {"exposure": 2.0}},
]
N_FRAMES = 7


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    cases.cap_threads()
    with cases.standin_resources(tmp_path_factory.mktemp("standin")) as cfg:
        yield cfg


@pytest.fixture(scope="module")
def jax_run(standin):
    """The JAX package's Session on SCRIPT (compiled once for the module):
    its frames, final camera pose and tuned caps."""
    from bibim_tpu.host.gui import UiState as JUiState
    from bibim_tpu.host.session import Session as JSession

    s = JSession(width=W, height=H, readback_depth=1,
                 ui=JUiState(scene="triangle", enable_tone_mapping=True))
    frames = list(s.run_script(SCRIPT, N_FRAMES, dt=0.1))
    return dict(frames=frames, pos=s.camera.pos.copy(), yaw=s.camera.yaw,
                pitch=s.camera.pitch, tuned=dict(s._tuned))


def _session(**ui_kwargs):
    ui = UiState(**{"scene": "triangle", "enable_tone_mapping": True,
                    **ui_kwargs})
    return Session(width=W, height=H, ui=ui, readback_depth=1, device="cpu")


def _direct(s: Session, hud=None) -> np.ndarray:
    """The port's render_frame at the session's pose, toggles and tuned
    settings, on inputs built here."""
    cam, ui = s.camera, s.ui
    vb = ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix()),
        proj=m3.perspective(60.0, s.width / s.height, 0.1, 1000.0,
                            device="cpu"),
        view_pos=torch.as_tensor(cam.pos),
        enable_normal_map=torch.tensor(int(ui.enable_normal_map),
                                       dtype=torch.int32))
    fp = FrameParams(
        enable_tone_mapping=torch.tensor(int(ui.enable_tone_mapping),
                                         dtype=torch.int32),
        exposure=torch.tensor(ui.exposure, dtype=torch.float32))
    if ui.scene == "cube":
        from bibim_tpu_torch.scene.cube import cube_scene_materials

        mats = cube_scene_materials(device="cpu")
    else:
        mats = material_quads_from_set(s.material_set(),
                                       ui.selected_material, device="cpu")
    out = render_frame(s.scene.scene_data(), vb, fp, mats, s.overlay(),
                       s.settings(), hud=hud)
    return out["image"].numpy()


# ---------------------------------------------------------------------------
# tests/test_session.py's behaviours, on the port
# ---------------------------------------------------------------------------

class TestEventReplay:
    def test_wasd_and_drag_change_the_image(self, standin):
        script = [
            {"frame": 1, "key": "w", "down": True},
            {"frame": 3, "key": "w", "down": False},
            {"frame": 3, "mouse": True, "cursor": [0, 0]},
            {"frame": 4, "cursor": [30, -10]},
        ]
        s = _session()
        frames = list(s.run_script(script, n_frames=6, dt=0.1))
        assert len(frames) == 6
        assert not np.array_equal(frames[0], frames[2])
        assert not np.array_equal(frames[2], frames[5])
        assert s.camera.pos[2] == pytest.approx(4.0 * 0.1 * 2)
        assert s.camera.yaw == pytest.approx(-30 * 0.6)
        assert s.camera.pitch == pytest.approx(10 * 0.6)

    def test_pitch_clamps_at_88_degrees(self, standin):
        s = _session()
        s.handle_event({"mouse": True, "cursor": [0, 0]})
        s.render(0.1)
        s.handle_event({"cursor": [0, 1000]})
        s.render(0.1)
        assert s.camera.pitch == -88.0

    def test_live_resize_mid_script(self, standin):
        s = _session()
        frames = list(s.run_script([{"frame": 2, "set": {"size": [192, 96]}}],
                                   n_frames=4, dt=0.1))
        assert [f.shape for f in frames] == [(64, 128, 3)] * 2 + [
            (96, 192, 3)] * 2
        assert frames[3].max() > 0

    def test_hud_in_session_frames(self, standin):
        s = _session(show_hud=True)
        frames = list(s.run_script([], n_frames=2, dt=0.1))
        top = frames[-1][:24, :, :]
        assert (top == 255).all(axis=-1).any()


class TestRuntimeSwitching:
    def test_scene_switch_without_restart(self, standin):
        s = _session()
        frames = list(s.run_script([{"frame": 2, "set": {"scene": "gizmo"}}],
                                   n_frames=4, dt=0.1))
        assert not np.array_equal(frames[1], frames[2])
        assert {k[0] for k in s._scenes} == {"triangle", "gizmo"}

    def test_material_switch_rebinds(self, standin):
        s = _session(scene="shaderball")
        img0 = s.render(0.1)
        s.handle_event({"set": {"selected_material": 0}})
        img1 = s.render(0.1)
        assert 0 in s._materials and 1 in s._materials
        assert not np.array_equal(img0, img1)

    def test_ui_toggles_apply(self, standin):
        s = _session()
        base = s.render(0.1)
        s.handle_event({"set": {"exposure": 8.0}})
        hot = s.render(0.1)
        assert hot.astype(int).sum() > base.astype(int).sum()

    def test_unknown_ui_field_rejected(self, standin):
        s = _session()
        with pytest.raises(ValueError):
            s.handle_event({"set": {"nonsense": 1}})

    def test_aniso_toggle_reaches_settings(self, standin):
        s = _session()
        assert s.settings().aniso_taps == 1
        s.handle_event({"set": {"aniso_taps": 4}})
        assert s.settings().aniso_taps == 4
        s.handle_event({"set": {"aniso_taps": 99}})
        assert s.settings().aniso_taps == 16
        s.handle_event({"set": {"aniso_taps": 0}})
        assert s.settings().aniso_taps == 1


def test_material_previews(standin, tmp_path):
    from PIL import Image

    from bibim_tpu_torch.assets.materials import create_pbr_material_set
    from bibim_tpu_torch.host.session import save_material_previews

    out = save_material_previews(create_pbr_material_set(),
                                 str(tmp_path / "mats.png"), tile=32)
    sheet = np.asarray(Image.open(out))
    assert sheet.shape == (2 * 32, 6 * 32, 3)
    assert sheet.any()


def test_mesh_scene_in_the_session(standin, tmp_path):
    """Bring-your-own-asset path (scene "mesh" on a torus OBJ)."""
    import chip_smoke

    path = tmp_path / "torus.obj"
    chip_smoke.write_torus_obj(path)
    s = _session(scene="mesh", mesh_path=str(path))
    img = s.render(0.1)
    assert np.array_equal(img, _direct(s))
    assert (img != 0).any(axis=-1).mean() > 0.05


# ---------------------------------------------------------------------------
# Session frames against render_frame; the device default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_session_frames_equal_direct_renders(standin, depth):
    """Every frame the session hands back (``depth - 1`` frames after its
    dispatch) equals the port's render_frame at that frame's pose and
    settings: WASD, a drag, a material switch, the normal map, the
    forward path and the cube scene."""
    script = SCRIPT + [
        {"frame": 6, "set": {"scene": "shaderball"}},
        {"frame": 7, "set": {"selected_material": 0,
                             "enable_normal_map": True}},
        {"frame": 8, "set": {"deferred": False}},
        {"frame": 9, "set": {"scene": "cube", "deferred": True}},
    ]
    s = _session()
    s.readback = type(s.readback)(depth=depth)
    by_frame = {}
    for ev in script:
        by_frame.setdefault(ev["frame"], []).append(ev)
    want, got = [], []
    for f in range(10):
        for ev in by_frame.get(f, []):
            s.handle_event(ev)
        img = s.render(0.1)
        want.append(_direct(s))
        if img is not None:
            got.append(img)
    got += s.flush()
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i
    assert len({g.tobytes() for g in got}) >= 8


def test_session_defaults_to_cuda():
    assert inspect.signature(Session).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Session()


# ---------------------------------------------------------------------------
# Against the JAX package's Session
# ---------------------------------------------------------------------------

def test_camera_pose_matches_jax(jax_run):
    s = _session()
    frames = list(s.run_script(SCRIPT, N_FRAMES, dt=0.1))
    assert len(frames) == len(jax_run["frames"]) == N_FRAMES
    assert np.array_equal(s.camera.pos, jax_run["pos"])
    assert (s.camera.yaw, s.camera.pitch) == (jax_run["yaw"],
                                              jax_run["pitch"])


def test_retuned_caps_match_jax(jax_run):
    """The caps the session derives for the triangle scene (autotune at
    the default margin, merged by the session's rule) equal the JAX
    Session's ``_tuned`` entry field for field."""
    s = _session()
    list(s.run_script(SCRIPT, N_FRAMES, dt=0.1))
    assert s._tuned == jax_run["tuned"]
    assert [k for k, _ in s.retunes] == list(jax_run["tuned"])


def test_merge_caps_rule():
    from bibim_tpu_torch.pipeline import RenderSettings

    old = dict(max_candidates=64, raster_passes=2, overflow_cap=64,
               pair_budget=8192, live_tile_cap=None, raster_tile_cap=32,
               overlay_candidates=128, overlay_max_tiles=64,
               overlay_overflow_cap=512, span_cap=16, span_mid_cap=4096)
    new = RenderSettings(max_candidates=32, raster_passes=1, pair_budget=4096,
                         live_tile_cap=16, raster_tile_cap=None, span_cap=4,
                         span_mid_cap=None, overlay_max_tiles=128)
    caps = merge_caps(old, new)
    # RenderSettings' default overlay_candidates (384) beats the old 128;
    # every cap grows, the span routing too (None: uncapped, no mid class).
    assert caps == dict(old, overlay_candidates=384, overlay_max_tiles=128,
                        raster_tile_cap=None, span_mid_cap=None)
    assert merge_caps(None, new)["max_candidates"] == 32


def test_session_frame_within_golden_bound_of_jax(jax_run):
    """The last frame of SCRIPT (moved, turned, exposure 2) from both
    packages' sessions: within the golden bound (≤2 LSB, ≤0.1 % of
    pixels)."""
    s = _session()
    frames = list(s.run_script(SCRIPT, N_FRAMES, dt=0.1))
    for got, want in zip(frames, jax_run["frames"]):
        cases.assert_image_bound(got, np.asarray(want))
    assert not np.array_equal(frames[0], frames[-1])
