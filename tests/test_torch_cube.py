"""BASELINE config 2 through the port's render_frame vs the JAX package's:
two textured cubes, trilinear mip-block albedos, two materials routed per
pixel by ``batch_material_ids``, at 256×128 with seeded stand-in albedos
(64² and 32²; uv_debug.png and texture.jpg are not in the repository).
The plain chain ("full"), the compacted production path (K1 / K3 / K2 with
the mip-block and routed small groups), the five G-buffer views (K8 and
K7) and a deferred IBL frame on the mip binding (K8 → K5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu import math3d as jm3
from bibim_tpu.assets.image import build_mip_pyramid as j_mip_pyramid
from bibim_tpu.ops import ibl as jibl
from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.ops.tonemap import srgb_encode as j_srgb
from bibim_tpu.ops.tonemap import to_u8 as j_to_u8
from bibim_tpu.ops.tonemap import tone_map as j_tone_map
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu.scene.camera import FreeLookCamera as JCamera
from bibim_tpu.scene.cube import CubeScene as JCubeScene
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.pipeline import (
    KERNELS,
    GBufferViz,
    Kernels,
    RenderSettings,
    render_frame,
)
from bibim_tpu_torch.scene.cube import CubeScene, cube_material_tables
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import assert_image_bound

W, H = 256, 128
BASE = dict(width=W, height=H, batch_material_ids=(0, 1), show_gizmo=False,
            show_lights=False, max_candidates=512, overflow_cap=64,
            span_cap=64, xla_cap=2048)
# The compacted production path: 12 of the 32 tiles hold the cubes.
PROD = dict(max_candidates=64, raster_passes=3, live_tile_cap=20,
            raster_tile_cap=24)


def _albedos():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (n, n, 4), dtype=np.uint8) for n in (64, 32)]


def _jax_cube_tables(albedos):
    """The JAX package's ``cube_scene_materials`` body on given albedos."""
    def neutral(rgba):
        return np.tile(np.asarray(rgba, np.uint8), (4, 4, 1))

    n_norm = neutral((128, 128, 255, 255))
    mats = []
    for albedo in albedos:
        alb = j_mip_pyramid(albedo)
        mats.append(jtq.build_mip_block_tables({
            "alb_r": [m[:, :, 0:1] for m in alb],
            "alb_g": [m[:, :, 1:2] for m in alb],
            "alb_b": [m[:, :, 2:3] for m in alb],
            "nrm_x": [n_norm[:, :, 0:1]], "nrm_y": [n_norm[:, :, 1:2]],
            "nrm_z": [n_norm[:, :, 2:3]],
            "metallic": [neutral((0, 0, 0, 255))],
            "roughness": [neutral((180, 180, 180, 255))],
            "ao": [neutral((255, 255, 255, 255))],
            "height": [neutral((0, 0, 0, 255))],
        }))
    return jtq.merge_mip_block_materials(tuple(mats))


@pytest.fixture(scope="module")
def inputs():
    """(JAX scene, view block, frame params, tables), and the same carried
    into the port."""
    cases.cap_threads()
    cam = JCamera()
    vb = jfg.ViewBlock(view=jnp.asarray(cam.get_view_matrix()),
                       proj=jm3.perspective(60.0, W / H, 0.1, 1000.0),
                       view_pos=jnp.asarray(cam.pos),
                       enable_normal_map=jnp.int32(0))
    fp = jfg.FrameParams(enable_tone_mapping=jnp.int32(1),
                         exposure=jnp.float32(1.0))
    jin = (JCubeScene().scene_data(), vb, fp, _jax_cube_tables(_albedos()))
    port = (interop.scene_data(jin[0], device="cpu"),
            interop.view_block(vb, device="cpu"),
            interop.frame_params(fp, device="cpu"),
            interop.material_tables(jin[3], device="cpu"))
    return jin, port


@pytest.fixture(scope="module")
def jax_full(inputs):
    jin, _ = inputs
    out = jfg.render_frame(*jin, None,
                           jfg.RenderSettings(outputs="full", **BASE))
    return jax.tree_util.tree_map(np.asarray, out)


def _port(inputs, kernels=KERNELS, **kw):
    _, pin = inputs
    return render_frame(*pin, None, RenderSettings(**{**BASE, **kw}),
                        kernels=kernels)


def _spy(calls: dict) -> Kernels:
    """KERNELS, recording each entry point's arguments."""
    def wrap(name, fn):
        def run(*args, **kw):
            calls.setdefault(name, []).append((args, kw))
            return fn(*args, **kw)
        return run

    return Kernels(*(wrap(n, f) for n, f in zip(Kernels._fields, KERNELS)))


def test_cube_scene_and_tables_match_jax(inputs):
    """scene/cube.py: the port's CubeScene and cube_material_tables equal
    the JAX package's scene and binding."""
    jin, pin = inputs
    scene = CubeScene(device="cpu").scene_data()
    for got, want in zip(scene.batches, pin[0].batches):
        for f in ("positions", "uvs", "normals", "tangents", "indices",
                  "model", "inv_model"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in scene.lights._fields:
        assert torch.equal(getattr(scene.lights, f),
                           getattr(pin[0].lights, f)), f
    tables = cube_material_tables(_albedos(), device="cpu")
    assert [type(t).__name__ for t in tables] == ["MipBlockMulti",
                                                  "MipQuadMulti"]
    for got, want in zip(tables, pin[3]):
        assert tuple(got[1:]) == tuple(want[1:])
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("layout", ["block", "quad"])
def test_cube_scene_materials_real_albedos(layout):
    """cube_scene_materials on uv_debug.png and texture.jpg byte-equal to
    the JAX package's binding (skips without the two images)."""
    from bibim_tpu.scene.cube import cube_scene_materials as j_materials
    from bibim_tpu.utils.config import get_resource_root

    from bibim_tpu_torch.scene.cube import cube_scene_materials

    root = get_resource_root()
    for name in ("uv_debug.png", "texture.jpg"):
        if not root.common(name).is_file():
            pytest.skip(f"{name} not found (resource root "
                        f"{root.common_root})")
    want = interop.material_tables(j_materials(layout=layout), device="cpu")
    got = cube_scene_materials(layout, device="cpu")
    assert [type(t) for t in got] == [type(t) for t in want]
    for g, w in zip(got, want):
        assert tuple(g[1:]) == tuple(w[1:])
        assert torch.equal(g[0], w[0])


def test_cube_full_frame_matches_jax(inputs, jax_full):
    """The plain chain (mip samplers routed by the material-id plane)."""
    out = _port(inputs, outputs="full")
    np.testing.assert_array_equal(out["tri_id"].numpy(), jax_full["tri_id"])
    assert 0.1 < (jax_full["tri_id"] >= 0).mean() < 0.5
    assert_image_bound(out["image"].numpy(), jax_full["image"])
    for name in ("position", "normal", "albedo", "mrah", "matindex"):
        np.testing.assert_allclose(out["gbuffer"][name].numpy(),
                                   jax_full["gbuffer"][name], atol=2e-3)


def test_cube_production_frame_matches_jax(inputs, jax_full):
    """Compacted production frame: K2 samples the mip-block and the
    material-routed small group with the compacted material-id plane;
    zero drops, within the image bound of the JAX frame."""
    calls = {}
    out = _port(inputs, _spy(calls), outputs="image+diag", **PROD)
    check_bin_diag(out["bin_diag"])
    assert_image_bound(out["image"].numpy(), jax_full["image"])
    (args, kw), = calls["shade"]
    assert [type(t).__name__ for t in args[0]] == ["MipBlockMulti",
                                                   "MipQuadMulti"]
    mat, valid = kw["mat_id"], args[6]
    assert mat.shape == (PROD["live_tile_cap"], 1024)
    assert set(mat[valid].unique().tolist()) == {0, 1}
    assert "sample_mip_block" not in calls


@pytest.mark.parametrize("view", [GBufferViz.ALBEDO, GBufferViz.MRHA],
                         ids=["albedo", "mrha"])
def test_gbuffer_view_matches_jax(inputs, view):
    """The G-buffer views that show K8's (ALBEDO) and K7's (MRHA, the
    routed neutral group) output, against the JAX package's frame."""
    jin, _ = inputs
    want = np.asarray(jfg.render_frame(
        *jin, None, jfg.RenderSettings(outputs="image", gbuffer_viz=view,
                                       **BASE))["image"])
    calls = {}
    out = _port(inputs, _spy(calls), outputs="image+diag", gbuffer_viz=view,
                **PROD)
    check_bin_diag(out["bin_diag"])
    assert_image_bound(out["image"].numpy(), want)
    assert len(calls["sample_mip_block"]) == len(calls["sample_small"]) == 1
    assert "shade" not in calls and "shade_gbuffer" not in calls


@pytest.mark.parametrize("view", [GBufferViz.POSITION, GBufferViz.NORMAL,
                                  GBufferViz.MATERIAL_INDEX],
                         ids=["position", "normal", "material_index"])
def test_gbuffer_view_shows_planes(inputs, jax_full, view):
    """The other views: the JAX frame's G-buffer planes through the
    reference's viz tail (fp16, tone map, sRGB, u8)."""
    plane = jax_full["gbuffer"][{GBufferViz.POSITION: "position",
                                 GBufferViz.NORMAL: "normal",
                                 GBufferViz.MATERIAL_INDEX: "matindex"}[view]]
    hdr = jnp.asarray(plane).astype(jnp.float16).astype(jnp.float32)
    want = np.asarray(j_to_u8(j_srgb(j_tone_map(hdr, jnp.int32(1),
                                                jnp.float32(1.0)))))
    out = _port(inputs, outputs="image", gbuffer_viz=view)
    assert_image_bound(out["image"].numpy(), want)


def test_cube_ibl_frame_matches_jax(inputs):
    """Deferred IBL on the mip binding: G-buffer planes through K8 and K7,
    the IBL ambient, then K5."""
    jin, pin = inputs
    want = np.asarray(jfg.render_frame(
        *jin, None, jfg.RenderSettings(outputs="image", enable_ibl=True,
                                       **BASE),
        ibl=jibl.make_ibl_sh())["image"])
    calls = {}
    out = render_frame(*pin, None, RenderSettings(
        **{**BASE, **PROD}, outputs="image+diag", enable_ibl=True),
        ibl=interop.ibl(jibl.make_ibl_sh(), device="cpu"), kernels=_spy(calls))
    check_bin_diag(out["bin_diag"])
    assert_image_bound(out["image"].numpy(), want)
    assert {"sample_mip_block", "sample_small", "shade_gbuffer"} <= set(calls)
    plain = _port(inputs, outputs="image")["image"].numpy()
    assert not np.array_equal(out["image"].numpy(), plain)


def test_mixed_bindings_raise(inputs):
    _, pin = inputs
    quad = tq.build_quad_tables({"ao": np.zeros((4, 4, 1), np.uint8)},
                                device="cpu")
    with pytest.raises(NotImplementedError):
        render_frame(*pin[:3], pin[3] + quad, None,
                     RenderSettings(outputs="image", **BASE))
