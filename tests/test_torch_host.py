"""The port's host building blocks against the JAX package on the CPU:
UiState, Input, Stopwatch and FrameStats on the same event sequences, the
2-deep readback, save_png, the asset cache's tags, the stand-in
ShaderBall.fbx (chip_smoke.write_fbx_mesh) read by both FBX loaders, and
the scenes' update_scene against the JAX scenes, bit for bit."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from bibim_tpu.host.gui import UiState as JUiState
from bibim_tpu.scene.input import Input as JInput
from bibim_tpu.utils import profiling as jprof
from bibim_tpu.utils import timing as jtiming
from bibim_tpu_torch.host.gui import UiState
from bibim_tpu_torch.host.readback import DoubleBufferedReadback
from bibim_tpu_torch.scene.input import Input
from bibim_tpu_torch.utils import profiling as pprof
from bibim_tpu_torch.utils import timing as ptiming
from tests import torch_port_cases as cases


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    with cases.standin_resources(tmp_path_factory.mktemp("standin")) as cfg:
        yield cfg


# ---------------------------------------------------------------------------
# UiState, Input, Stopwatch, FrameStats
# ---------------------------------------------------------------------------

_UI_SETS = [
    {"exposure": 50.0, "camera_pitch": -120.0, "aniso_taps": 0},
    {"exposure": 0.0, "camera_pitch": 40.0, "aniso_taps": 99},
    {"exposure": 2.5, "scene": "gizmo", "deferred": False,
     "gbuffer_viz": "albedo", "selected_material": 0, "aniso_taps": 4},
]


def test_ui_state_matches_jax(tmp_path):
    from dataclasses import asdict

    port, jax = UiState(), JUiState()
    assert asdict(port) == asdict(jax)
    for fields in _UI_SETS:
        for k, v in fields.items():
            setattr(port, k, v)
            setattr(jax, k, v)
        port.clamp()
        jax.clamp()
        assert asdict(port) == asdict(jax)
    # Each package loads the other's file and clamps it the same way.
    port.save(tmp_path / "p.json")
    jax.save(tmp_path / "j.json")
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    assert asdict(JUiState.load(tmp_path / "p.json")) == asdict(
        UiState.load(tmp_path / "j.json"))


def test_input_matches_jax():
    events = [("key", "W", True), ("cursor", 10, 4), ("key", "a", True),
              ("mouse", True), ("cursor", -3, 12), ("key", "w", False),
              ("key", "D", True), ("cursor", 0, 0), ("key", "s", True),
              ("mouse", False), ("key", "a", False)]
    port, jax = Input(), JInput()
    for ev in events:
        for inp in (port, jax):
            if ev[0] == "key":
                inp.process_key_event(ev[1], ev[2])
            elif ev[0] == "cursor":
                inp.update_cursor(ev[1], ev[2])
            else:
                inp.mouse_down = ev[1]
        assert port.movement_direction() == jax.movement_direction()
        assert (port.cursor_pos, port.cursor_delta, port.mouse_down) == (
            jax.cursor_pos, jax.cursor_delta, jax.mouse_down)
        assert port.is_key_down("W") == jax.is_key_down("w")


def test_stopwatch_and_frame_stats_match_jax(monkeypatch):
    clock = iter(np.cumsum([1.0] + [0.016, 0.02, 0.0, 0.05, 0.033] * 30))
    now = [0.0]

    def fake():
        return now[0]

    monkeypatch.setattr("time.perf_counter", fake)
    port_sw, jax_sw = ptiming.Stopwatch(), jtiming.Stopwatch()
    port_fs, jax_fs = pprof.FrameStats(window=7), jprof.FrameStats(window=7)
    for t in clock:
        now[0] = float(t)
        assert port_sw.tick() == jax_sw.tick()
        assert port_fs.tick() == jax_fs.tick()
        assert port_fs.ms_per_frame == jax_fs.ms_per_frame
        assert port_fs.fps == jax_fs.fps
        assert port_fs.summary() == jax_fs.summary()
    assert ptiming.get_elapsed_time_in_seconds(2.0, 5.5) == 3.5


def test_stage_scope_and_device_trace(tmp_path):
    with pprof.device_trace(str(tmp_path)):
        with pprof.stage_scope("bibim-stage"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "bibim-stage"
               for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# Readback
# ---------------------------------------------------------------------------

def test_readback_depth_semantics():
    frames = [torch.full((2, 3, 3), i, dtype=torch.uint8) for i in range(5)]
    one = DoubleBufferedReadback(depth=1)
    for f in frames:
        got = one.submit(f)
        assert isinstance(got, np.ndarray) and np.array_equal(got, f.numpy())
    assert one.flush() == []

    two = DoubleBufferedReadback(depth=2)
    assert two.submit(frames[0]) is None
    for i in range(1, 5):
        assert int(two.submit(frames[i])[0, 0, 0]) == i - 1
    rest = two.flush()
    assert [int(r[0, 0, 0]) for r in rest] == [4]
    assert two.flush() == []

    three = DoubleBufferedReadback(depth=3)
    assert three.submit(frames[0]) is None
    assert three.submit(frames[1]) is None
    assert int(three.submit(frames[2])[0, 0, 0]) == 0
    assert [int(r[0, 0, 0]) for r in three.flush()] == [1, 2]
    with pytest.raises(ValueError):
        DoubleBufferedReadback(depth=0)


def test_readback_tuples_and_independent_copies():
    """A frame of several tensors comes back as a tuple of arrays, each a
    copy taken at submit: later writes to the tensor do not reach it."""
    rb = DoubleBufferedReadback(depth=2)
    img = torch.zeros((4, 4, 3), dtype=torch.uint8)
    diag = torch.tensor([0, 3, 0, 0])
    assert rb.submit((img, diag)) is None
    img += 7
    got_img, got_diag = rb.submit((img, diag * 0))
    assert not got_img.any() and got_diag.tolist() == [0, 3, 0, 0]
    (last_img, last_diag), = rb.flush()
    assert (last_img == 7).all() and not last_diag.any()


# ---------------------------------------------------------------------------
# save_png, native
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native_lib", [True, False])
def test_save_png_round_trip(tmp_path, monkeypatch, native_lib):
    from bibim_tpu_torch import native
    from bibim_tpu_torch.assets.image import load_image_rgba8, save_png

    if not native_lib:
        monkeypatch.setattr(native, "_lib", lambda: None)
        assert not native.write_png(str(tmp_path / "x.png"),
                                    np.zeros((2, 2, 3), np.uint8))
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (9, 5, 4), dtype=np.uint8)
    save_png(tmp_path / "rgb.png", rgb)
    save_png(tmp_path / "sub" / "rgba.png", rgba)
    save_png(tmp_path / "f.png", np.full((3, 3, 3), 0.5, np.float32))
    assert np.array_equal(load_image_rgba8(tmp_path / "rgb.png")[..., :3],
                          rgb)
    assert np.array_equal(load_image_rgba8(tmp_path / "sub" / "rgba.png"),
                          rgba)
    assert (np.asarray(Image.open(tmp_path / "f.png")) == 128).all()


def test_native_decode_matches_pil(tmp_path):
    from bibim_tpu_torch import native
    from bibim_tpu_torch.assets.image import load_image_rgba8

    if native.native_version() is None:
        pytest.skip("native/libbibim_native.so does not load here")
    img = np.random.default_rng(4).integers(0, 256, (8, 12, 4), np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    assert np.array_equal(native.decode_image_rgba8(str(tmp_path / "a.png")),
                          load_image_rgba8(tmp_path / "a.png"))
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((4, 4), np.uint8))


# ---------------------------------------------------------------------------
# Asset cache, the stand-in FBX
# ---------------------------------------------------------------------------

def test_asset_cache_tags_never_collide_with_jax(standin, tmp_path,
                                                 monkeypatch):
    """Both packages cache the stand-in's FBX and material set into one
    directory: the port's entries are its own (``torch-`` tags, no file
    shared with the JAX package's), and unpickle without the JAX
    package."""
    from bibim_tpu.assets import asset_cache as jcache
    from bibim_tpu.assets.fbx import load_fbx_mesh as jload
    from bibim_tpu.assets.materials import create_pbr_material_set as jset
    from bibim_tpu_torch.assets import asset_cache as pcache
    from bibim_tpu_torch.assets.fbx import load_fbx_mesh as pload
    from bibim_tpu_torch.assets.materials import create_pbr_material_set
    from bibim_tpu_torch.utils.config import get_resource_root

    monkeypatch.setattr(jcache, "_CACHE_DIR", tmp_path)
    monkeypatch.setattr(pcache, "CACHE_DIR", tmp_path)
    fbx = get_resource_root().common("ShaderBall.fbx")
    jload(fbx), jset()
    jax_files = {p.name for p in tmp_path.glob("*.pkl")}
    port_mesh, port_set = pload(fbx), create_pbr_material_set()
    port_files = {p.name for p in tmp_path.glob("*.pkl")} - jax_files
    assert len(jax_files) == 2 and len(port_files) == 2
    assert all(f.startswith(pcache.TAG_PREFIX) for f in port_files)
    assert not any(f.startswith(pcache.TAG_PREFIX) for f in jax_files)
    for f in port_files:
        data = (tmp_path / f).read_bytes()
        assert b"bibim_tpu_torch" in data
        assert b"bibim_tpu." not in data.replace(b"bibim_tpu_torch", b"")
    # A second load comes from the port's entries.
    assert type(pload(fbx)) is type(port_mesh)
    assert create_pbr_material_set().names == port_set.names
    with pytest.raises(ValueError):
        pcache.cache_file("fbx0", [fbx])


def test_standin_fbx_read_by_both_loaders(standin):
    """The stand-in ShaderBall.fbx (binary FBX 7.4, uvs by IndexToDirect)
    gives both packages' loaders the mesh it was written from."""
    import chip_smoke
    from bibim_tpu.assets.fbx import load_fbx_mesh as jload
    from bibim_tpu_torch.assets.fbx import load_fbx_mesh as pload
    from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
    from bibim_tpu_torch.utils.config import get_resource_root

    src = generate_uv_sphere_mesh(*chip_smoke.BALL_SPHERE)
    flat = src.indices.reshape(-1)
    fbx = get_resource_root().common("ShaderBall.fbx")
    for mesh in (pload(fbx), jload(fbx)):
        assert np.array_equal(mesh.positions, src.positions[flat])
        assert np.array_equal(mesh.normals, src.normals[flat])
        assert np.array_equal(mesh.uvs, src.uvs[flat])
        assert mesh.indices.shape == (10000, 3)
    assert np.array_equal(pload(fbx).tangents, jload(fbx).tangents)


# ---------------------------------------------------------------------------
# Scene updates
# ---------------------------------------------------------------------------

# Past 360° (ShaderBall starts at -90°, so 15 s of spin wraps it once).
_DTS = (0.0, 1 / 60, 0.5, 7.25, 6.5, 1.0, 0.3)


def _matrices(data):
    return [(np.asarray(b.model), np.asarray(b.inv_model))
            for b in data.batches]


def _assert_same_matrices(port, jax):
    for (pm, pi), (jm, ji) in zip(_matrices(port), _matrices(jax)):
        assert pm.dtype == jm.dtype == np.float32
        assert np.array_equal(pm, jm) and np.array_equal(pi, ji)


@pytest.mark.parametrize("spin", [False, True])
def test_shaderball_update_scene_matches_jax(standin, spin):
    from bibim_tpu.scene.shaderball import ShaderBallScene as JScene
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    port = ShaderBallScene(num_instances=3, spin=spin, device="cpu")
    jax = JScene(num_instances=3, spin=spin)
    for dt in _DTS:
        port.update_scene(dt)
        jax.update_scene(dt)
        assert port.angle == jax.angle
        _assert_same_matrices(port.scene_data(), jax.scene_data())
        # The cull reads host copies that follow the device matrices.
        host = port.host_instances[0]
        assert np.array_equal(host.model, np.asarray(jax._ball.model))
        assert np.array_equal(host.inv_model,
                              np.asarray(jax._ball.inv_model))
    assert (port.angle != -90.0) == spin
    assert port.selected_material == jax.selected_material == 1


@pytest.mark.parametrize("spin", [False, True])
def test_cube_update_scene_matches_jax(spin):
    """Cube A only turns; its inverse stays the constructed one, as in
    the JAX package's CubeScene."""
    from bibim_tpu.scene.cube import CubeScene as JCube
    from bibim_tpu_torch.scene.cube import CubeScene

    port, jax = CubeScene(spin=spin, device="cpu"), JCube(spin=spin)
    first = _matrices(port.scene_data())
    for dt in _DTS:
        port.update_scene(dt)
        jax.update_scene(dt)
        _assert_same_matrices(port.scene_data(), jax.scene_data())
    now = _matrices(port.scene_data())
    assert np.array_equal(now[1][0], first[1][0])
    assert np.array_equal(now[0][1], first[0][1])
    assert np.array_equal(now[0][0], first[0][0]) != spin
    assert port.selected_material == 0


def test_static_scenes_update_scene_is_a_no_op(standin):
    from bibim_tpu.scene.gizmoscene import GizmoScene as JGizmo
    from bibim_tpu.scene.triangle import TriangleScene as JTriangle
    from bibim_tpu_torch.scene.gizmoscene import GizmoScene
    from bibim_tpu_torch.scene.scene import SceneBase
    from bibim_tpu_torch.scene.triangle import TriangleScene

    for port, jax in ((TriangleScene(device="cpu"), JTriangle()),
                      (GizmoScene(device="cpu"), JGizmo())):
        assert isinstance(port, SceneBase)
        before = port.scene_data()
        for dt in _DTS:
            port.update_scene(dt)
            jax.update_scene(dt)
        assert port.scene_data() is before
        _assert_same_matrices(port.scene_data(), jax.scene_data())
        assert port.selected_material == jax.selected_material == 0

