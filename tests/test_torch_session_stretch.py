"""BASELINE config 5 (the ShaderBall frame with a shadow map and IBL) on
the port's interactive Session, on the CPU: ``UiState``'s
``enable_shadows`` and ``enable_ibl`` turned on by a ``set`` event, the
frames against the benchmark's plain reference of that frame
(``h100_bench/reference/shadow_ibl.py``) at the two poses its own tests
use, the frame with both off unchanged, the shadow caps the session
keeps, the light pass's spans and its launch counter, and the CLI and
viewer page that reach the toggles."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.host.gui import UiState
from bibim_tpu_torch.host.session import (
    SHADOW_CAPS,
    TUNED_CAPS,
    Session,
    merge_caps,
)
from bibim_tpu_torch.pipeline import (
    FrameParams,
    GBufferViz,
    RenderSettings,
    ViewBlock,
    make_overlay_resources,
    material_quads_from_set,
    render_frame,
)
from bibim_tpu_torch.pipeline.framegraph import KERNELS
from bibim_tpu_torch.utils import profiling
from h100_bench import check, harness
from h100_bench.standin import writers
from h100_bench.tests.conftest import BENCH
from tests import torch_port_cases as cases

W, H = 256, 144
SEED = 2**31 + 11
# The poses of h100_bench/tests/test_h100bench_reference.py
# SHADOW_IBL_CASES: the ball's shadow on the plane in view beside the
# ball (6 units from (0, 0, 2) at yaw 45°, pitch −30°); the ball and both
# light spheres from above.
POSES = {"shadow": ((3.6742349, 3.0, -1.6742349), 45.0, -30.0),
         "spheres": ((3.0, 1.0, -3.0), 40.0, -20.0)}
TOGGLES = ("enable_shadows", "enable_ibl")
STAGE_SPANS = ("shade.shadow_map", "shade.pcf", "shade.ibl")


def _config() -> dict:
    cfg = json.loads((BENCH / "configs" / "shaderball_4k_shadow_ibl.json")
                     .read_text())
    cfg.update(width=W, height=H)
    return cfg


def _pose(s: Session, pose) -> None:
    pos, yaw, pitch = pose
    s.camera.pos = np.asarray(pos, np.float32)
    s.camera.yaw, s.camera.pitch = float(yaw), float(pitch)


def _render(s: Session) -> tuple:
    """The frame at the session's pose, rendered again where it dropped
    geometry (the retune it caused, past a first bind's, raises the
    caps), and the recorder's records of the frame returned."""
    while True:
        n = len(s.retunes) + (s._tune_key() not in s._tuned)
        img = s.render(0.1)
        frame = max(r.frame for r in profiling.snapshot())
        if len(s.retunes) == n:
            return img, [r for r in profiling.snapshot() if r.frame == frame]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One session on a stand-in root of the benchmark's writers (64²
    maps): a frame at the shadow pose with both toggles off, then a
    ``set`` event turning both on and a frame at each pose; the plain
    reference of the configuration on the same root."""
    cases.cap_threads()
    tmp = tmp_path_factory.mktemp("stretch")
    config_path, _ = writers.prepare(tmp / "standin", SEED, map_size=64)
    cfg = _config()
    with cases.resource_root(config_path, tmp / "cache"):
        ui = UiState(scene="shaderball", deferred=cfg["deferred"],
                     enable_tone_mapping=cfg["tone_map"],
                     exposure=cfg["exposure"],
                     selected_material=cfg["material_index"])
        s = Session(width=W, height=H, ui=ui, readback_depth=1,
                    device="cpu")
        _pose(s, POSES["shadow"])
        off, off_recs = _render(s)
        out = dict(session=s, off=off, off_recs=off_recs,
                   off_settings=s.settings(), off_key=s._tune_key(),
                   off_retunes=len(s.retunes), frames={}, recs={})
        s.handle_event({"set": {k: True for k in TOGGLES}})
        for name in ("shadow", "spheres"):
            _pose(s, POSES[name])
            out["frames"][name], out["recs"][name] = _render(s)
        out["on_settings"] = s.settings()
        out["ref"] = harness.make_reference(cfg, config_path.parent, "cpu")
        out["no_shadows"] = harness.make_reference(
            dict(cfg, shadows=False), config_path.parent, "cpu")
        out["materials"] = material_quads_from_set(
            s.material_set(), cfg["material_index"], device="cpu")
        yield out


def _direct(s: Session, settings: RenderSettings, materials,
            kernels=KERNELS) -> dict:
    """``render_frame`` at the session's pose on inputs built here."""
    cam = s.camera
    vb = ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix()),
        proj=m3.perspective(60.0, W / H, 0.1, 1000.0, device="cpu"),
        view_pos=torch.as_tensor(cam.pos),
        enable_normal_map=torch.tensor(0, dtype=torch.int32))
    fp = FrameParams(enable_tone_mapping=torch.tensor(1, dtype=torch.int32),
                     exposure=torch.tensor(1.0, dtype=torch.float32))
    return render_frame(s.scene.scene_data(), vb, fp, materials,
                        make_overlay_resources(device="cpu"), settings,
                        kernels=kernels)


def test_frame_with_both_toggles_off_is_unchanged(run):
    """Both off: the settings of the frame without the toggles (the
    session's base fields and its tuned caps, nothing else), keyed by
    scene, instances and size alone, and the same image."""
    s = run["session"]
    caps = s._tuned[run["off_key"]]
    assert run["off_key"] == ("shaderball", 1, W, H)
    assert set(caps) == set(TUNED_CAPS)
    want = dataclasses.replace(RenderSettings(
        width=W, height=H, deferred=True, shading="pbr",
        gbuffer_viz=GBufferViz.RENDERED_SCENE, show_tbn=False,
        show_hud=False, aniso_taps=1,
        batch_material_ids=getattr(s.scene, "material_ids", None),
        outputs="image+diag"), **caps)
    assert run["off_settings"] == want
    _pose(s, POSES["shadow"])
    assert np.array_equal(
        run["off"], _direct(s, want, run["materials"])["image"].numpy())
    names = {r.name for r in run["off_recs"]}
    assert not names & {*STAGE_SPANS, "shadow_launches"}


def test_set_event_turns_both_on_and_retunes(run):
    s = run["session"]
    assert s.ui.enable_shadows and s.ui.enable_ibl
    key, caps = s.retunes[run["off_retunes"]]
    assert key == run["off_key"] + TOGGLES
    assert set(caps) == set(TUNED_CAPS + SHADOW_CAPS)
    got = run["on_settings"]
    assert got.enable_shadows and got.enable_ibl
    assert got.shadow_fit_batches == s.scene.shadow_fit_batches
    assert all(isinstance(caps[k], int) for k in ("shadow_candidates",
                                                  "shadow_passes"))
    for k in SHADOW_CAPS:
        assert getattr(got, k) == s._tuned[key][k]
    assert s.ibl() is s.ibl()


@pytest.mark.parametrize("pose", sorted(POSES))
def test_session_frame_matches_the_shadow_ibl_reference(run, pose):
    """Within the configuration's limits of the reference at both poses;
    at the shadow pose the frame differs from the reference without
    shadows, so the shadow is in view."""
    got = run["frames"][pose]
    want, mask = harness.reference_frame(run["ref"], POSES[pose])
    limits = _config()["limits"]
    r = check.frame_readings(got, want, mask)
    assert all(r[k] <= limits[k] for k in limits), r
    assert (got.max(-1) > 0).mean() > 0.05
    if pose == "shadow":
        flat, _ = harness.reference_frame(run["no_shadows"], POSES[pose])
        r = check.frame_readings(flat, want, mask)
        assert any(r[k] > limits[k] for k in limits), r


@pytest.mark.parametrize("pose", sorted(POSES))
def test_light_pass_spans_nest_in_frame_shade(run, pose):
    recs = run["recs"][pose]
    by_seq = {r.seq: r for r in recs}
    for name in STAGE_SPANS:
        (span,) = [r for r in recs if r.name == name and r.count is None]
        assert by_seq[span.parent].name == "frame.shade"
    launches = [r for r in recs if r.name == "shadow_launches"]
    assert launches and all(
        by_seq[r.parent].name == "shade.shadow_map" for r in launches)


def _counting(kernels, names, calls: list):
    def wrap(name, fn):
        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)

        return call

    return kernels._replace(**{n: wrap(n, getattr(kernels, n))
                               for n in names})


@pytest.mark.parametrize("passes", [1, 2])
def test_shadow_launches_counts_the_light_pass(run, passes):
    """The counter of a frame with shadows equals its raster and sort
    calls less those of the same frame without shadows (a 128² map fit to
    the ball, the light pass in ``passes`` passes: the second is K1's
    tail)."""
    s = run["session"]
    _pose(s, POSES["shadow"])
    names = ("raster", "raster_earlyz", "raster_tail", "sort")
    counts = {}
    for shadows in (False, True):
        calls = []
        settings = RenderSettings(
            width=W, height=H, outputs="image", enable_shadows=shadows,
            shadow_size=128, shadow_passes=passes,
            shadow_fit_batches=s.scene.shadow_fit_batches)
        profiling.next_frame()
        _direct(s, settings, run["materials"],
                _counting(KERNELS, names, calls))
        frame = max(r.frame for r in profiling.snapshot())
        counts[shadows] = (len(calls), sum(
            r.count for r in profiling.snapshot()
            if r.frame == frame and r.name == "shadow_launches"))
    assert counts[False][1] == 0
    assert counts[True][1] == counts[True][0] - counts[False][0]
    assert counts[True][1] >= 1 + passes  # a sort, pass 0, the tail


def test_merge_caps_grows_and_keeps_the_shadow_caps():
    old = merge_caps(None, RenderSettings(
        enable_shadows=True, shadow_candidates=256, shadow_passes=1,
        shadow_tile_cap=128, shadow_query_tile_cap=None))
    assert {k: old[k] for k in SHADOW_CAPS} == dict(
        shadow_candidates=256, shadow_passes=1, shadow_tile_cap=128,
        shadow_query_tile_cap=None)
    new = RenderSettings(enable_shadows=True, shadow_candidates=128,
                         shadow_passes=2, shadow_tile_cap=256,
                         shadow_query_tile_cap=64)
    caps = merge_caps(old, new)
    # Each grows; None stays uncapped.
    assert {k: caps[k] for k in SHADOW_CAPS} == dict(
        shadow_candidates=256, shadow_passes=2, shadow_tile_cap=256,
        shadow_query_tile_cap=None)
    # A frame without shadows tunes none of them.
    assert not set(SHADOW_CAPS) & set(merge_caps(None, RenderSettings()))


def test_shadows_need_a_directional_light_0(run):
    from bibim_tpu_torch.scene.lights import make_lights

    s = Session(width=W, height=H, device="cpu",
                ui=UiState(scene="shaderball", enable_shadows=True))
    data = run["session"].scene.scene_data()

    class PointLit:
        def scene_data(self):
            return data._replace(lights=make_lights([{"type": 0}],
                                                    device="cpu"))

    s._scenes[s._scene_key()] = PointLit()
    with pytest.raises(ValueError, match="directional"):
        s.settings()


def test_cli_session_takes_the_toggles(monkeypatch, tmp_path):
    """``--events`` / ``--serve`` hand ``--shadows`` and ``--ibl`` to the
    session's UiState."""
    from bibim_tpu_torch.host import app
    from bibim_tpu_torch.host import session as session_mod

    seen = []

    class Recorder:
        def __init__(self, width, height, ui, device):
            seen.append(ui)
            self.stats = session_mod.FrameStats()

        def run_script(self, events, n_frames):
            return iter(())

    monkeypatch.setattr(session_mod, "Session", Recorder)
    script = tmp_path / "script.json"
    script.write_text("[]")
    for flags in ([], ["--shadows"], ["--shadows", "--ibl"]):
        assert app.main(["--events", str(script), "--device", "cpu",
                         "--out", str(tmp_path / "f.png"), *flags]) == 0
    assert [(u.enable_shadows, u.enable_ibl) for u in seen] == [
        (False, False), (True, False), (True, True)]


def test_viewer_page_has_the_toggles():
    from bibim_tpu_torch.host import serve

    for ctl, field in (("shadows", "enable_shadows"), ("ibl", "enable_ibl")):
        assert f'<input id="{ctl}" type="checkbox">' in serve._PAGE
        assert f"post({{set: {{{field}: e.target.checked}}}})" in serve._PAGE
        assert f"el('{ctl}').checked = ui.{field};" in serve._PAGE
