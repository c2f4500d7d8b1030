"""The port's CLI (``python -m bibim_tpu_torch.host.app``) on the CPU
(``--device cpu``) on the stand-in resource root: each written PNG equals
the port's render_frame on inputs built here, the event-script replay
equals the Session's frames, and the material list and previews."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.host import app
from bibim_tpu_torch.pipeline import (
    FrameParams,
    RenderSettings,
    ViewBlock,
    make_overlay_resources,
    material_quads_from_set,
    render_frame,
)
from bibim_tpu_torch.scene.camera import FreeLookCamera
from tests import torch_port_cases as cases

W, H = 128, 64


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    cases.cap_threads()
    with cases.standin_resources(tmp_path_factory.mktemp("standin"),
                                 with_jax=False) as cfg:
        yield cfg


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    import chip_smoke

    path = tmp_path_factory.mktemp("mesh") / "torus.obj"
    chip_smoke.write_torus_obj(path)
    return str(path)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def _direct(scene, cam, fov, mats, **settings) -> np.ndarray:
    vb = ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix()),
        proj=m3.perspective(fov, W / H, 0.1, 1000.0, device="cpu"),
        view_pos=torch.as_tensor(cam.pos),
        enable_normal_map=torch.tensor(0, dtype=torch.int32))
    fp = FrameParams(enable_tone_mapping=torch.tensor(1, dtype=torch.int32),
                     exposure=torch.tensor(1.0, dtype=torch.float32))
    s = RenderSettings(width=W, height=H, outputs="image+diag", **settings)
    out = render_frame(scene.scene_data(), vb, fp, mats,
                       make_overlay_resources(device="cpu"), s)
    assert not any(int(x) for x in out["bin_diag"])
    return out["image"].numpy()


def _materials(index):
    from bibim_tpu_torch.assets.materials import create_pbr_material_set

    return material_quads_from_set(create_pbr_material_set(), index,
                                   device="cpu")


def _run(tmp_path, *argv) -> np.ndarray:
    out = tmp_path / "frame.png"
    assert app.main([*argv, "--size", str(W), str(H), "--device", "cpu",
                     "--out", str(out)]) == 0
    return _png(out)


def test_triangle_png_equals_direct_render(standin, tmp_path):
    from bibim_tpu_torch.scene.triangle import TriangleScene

    got = _run(tmp_path, "--scene", "triangle")
    want = _direct(TriangleScene(device="cpu"), FreeLookCamera(), 60.0,
                   _materials(0))
    assert np.array_equal(got, want) and got.any()


def test_gizmo_png_equals_direct_render(standin, tmp_path):
    from bibim_tpu_torch.scene.gizmoscene import (
        GIZMO_CAMERA_DISTANCE,
        GIZMO_FOV_DEGREES,
        GizmoScene,
    )

    got = _run(tmp_path, "--scene", "gizmo")
    cam = FreeLookCamera(pos=np.asarray([0, 0, -GIZMO_CAMERA_DISTANCE],
                                        np.float32))
    want = _direct(GizmoScene(device="cpu"), cam, GIZMO_FOV_DEGREES,
                   _materials(0), shading="flat")
    assert np.array_equal(got, want)
    assert (got != 0).any(axis=-1).mean() > 0.05


def test_mesh_png_equals_direct_render(standin, torus, tmp_path):
    from bibim_tpu_torch.scene.meshscene import MeshScene

    # 9,216 triangles in a few 8×128 tiles: past the default 320
    # candidates a tile.
    cam = [0.3, 0.2, -0.5, 8.0, -4.0]
    got = _run(tmp_path, "--scene", "mesh", "--mesh-path", torus,
               "--material", "0", "--camera", *map(str, cam),
               "--max-candidates", "4096")
    want = _direct(MeshScene(path=torus, device="cpu"),
                   FreeLookCamera(pos=np.asarray(cam[:3], np.float32),
                                  yaw=cam[3], pitch=cam[4]),
                   60.0, _materials(0), max_candidates=4096)
    assert np.array_equal(got, want)
    assert (got != 0).any(axis=-1).mean() > 0.05


def test_events_replay_equals_session(standin, tmp_path):
    from bibim_tpu_torch.host.gui import UiState
    from bibim_tpu_torch.host.session import Session

    script = [{"frame": 1, "key": "d", "down": True},
              {"frame": 2, "set": {"scene": "gizmo"}}]
    path = tmp_path / "script.json"
    path.write_text(json.dumps(script))
    out = tmp_path / "replay.png"
    assert app.main(["--scene", "triangle", "--events", str(path),
                     "--frames", "3", "--size", str(W), str(H),
                     "--device", "cpu", "--out", str(out)]) == 0
    got = [_png(tmp_path / f"replay_{i:04d}.png") for i in range(3)]
    s = Session(width=W, height=H, device="cpu",
                ui=UiState(scene="triangle", enable_tone_mapping=True))
    want = list(s.run_script(script, 3))
    assert len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_list_materials_and_previews(standin, tmp_path, capsys):
    assert app.main(["--list-materials"]) == 0
    assert capsys.readouterr().out.splitlines() == ["0: standin_a",
                                                    "1: standin_b"]
    sheet = tmp_path / "sheet.png"
    assert app.main(["--material-previews", str(sheet)]) == 0
    assert _png(sheet).shape == (2 * 128, 6 * 128, 3)


def test_parser_defaults_to_cuda():
    args = app.build_parser().parse_args([])
    assert args.device == "cuda" and args.scene == "shaderball"
    with pytest.raises(SystemExit):
        app.build_parser().parse_args(["--device", "tpu"])


def test_no_spans_switches_the_recorder_off(standin, monkeypatch, capsys):
    from bibim_tpu_torch.utils import profiling

    seen = []
    monkeypatch.setattr(profiling, "set_enabled", seen.append)
    assert app.main(["--list-materials", "--no-spans"]) == 0
    assert app.main(["--list-materials"]) == 0
    assert seen == [False, True]
