"""BASELINE config 1 in the port: the flat-shaded frame of GizmoScene
(``shading="flat"``, ``materials=None``, no lights, the gizmo camera)
against the JAX package's render_frame on the CPU, on a coloured stand-in
mesh built in both packages; the real gizmo.obj where the resource root
holds it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu import math3d as jm3
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu.scene import gizmoscene as jgz
from bibim_tpu.scene.camera import FreeLookCamera
from bibim_tpu_torch import interop
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.scene import gizmoscene as pgz
from bibim_tpu_torch.scene.meshgen import Mesh
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import assert_image_bound

SIZE = 256
# bench.py bench_gizmo: flat shading, no light spheres, no corner gizmo.
BASE = dict(width=SIZE, height=SIZE, shading="flat", show_lights=False,
            show_gizmo=False, max_candidates=256, span_cap=64, xla_cap=2048)


def _standin():
    """A coloured stand-in for gizmo.obj: a UV sphere of radius 6 (the
    gizmo's extent at the 27-unit camera) turned so that its poles face
    the camera at an angle, coloured by its normals."""
    from bibim_tpu.assets.meshgen import generate_uv_sphere_mesh

    m = generate_uv_sphere_mesh(6.0, 32, 20)
    rot = np.asarray(jm3.rotate_x(35.0) @ jm3.rotate_y(20.0))[:3, :3]
    pos = (np.asarray(m.positions) @ rot.T).astype(np.float32)
    nrm = (np.asarray(m.normals) @ rot.T).astype(np.float32)
    col = (0.2 + 0.8 * np.abs(nrm)).astype(np.float32)
    return Mesh(positions=pos, uvs=np.asarray(m.uvs, np.float32),
                normals=nrm, tangents=np.asarray(m.tangents, np.float32),
                indices=np.asarray(m.indices, np.int32), colors=col)


def _view():
    cam = FreeLookCamera(pos=np.array([0.0, 0.0, -jgz.GIZMO_CAMERA_DISTANCE],
                                      np.float32))
    vb = jfg.ViewBlock(
        view=jnp.asarray(cam.get_view_matrix()),
        proj=jm3.perspective(jgz.GIZMO_FOV_DEGREES, 1.0, 0.1, 1000.0),
        view_pos=jnp.asarray(cam.pos), enable_normal_map=jnp.int32(0))
    fp = jfg.FrameParams(enable_tone_mapping=jnp.int32(0),
                         exposure=jnp.float32(1.0))
    return vb, fp


def _frames(jscene, pscene, **kw):
    """(JAX image, port "full", port production, port production with a
    live-tile cap the flat frame does not compact by)."""
    vb, fp = _view()
    kw = {**BASE, **kw}
    want = np.asarray(jfg.render_frame(
        jscene, vb, fp, None, None,
        jfg.RenderSettings(outputs="image", **kw))["image"])
    pvb = interop.view_block(vb, device="cpu")
    pfp = interop.frame_params(fp, device="cpu")
    outs = [render_frame(pscene, pvb, pfp, None, None,
                         RenderSettings(**kw, **extra))
            for extra in (dict(outputs="full"),
                          dict(outputs="image+diag"),
                          dict(outputs="image+diag", live_tile_cap=8))]
    return want, outs


def test_constants_match_jax():
    assert pgz.GIZMO_CAMERA_DISTANCE == jgz.GIZMO_CAMERA_DISTANCE
    assert pgz.GIZMO_FOV_DEGREES == jgz.GIZMO_FOV_DEGREES


def test_flat_frame_matches_jax():
    """The stand-in's flat frame: the plain chain ("full") and the
    production path (K1, every raster plane but colour and normal
    dropped) at the golden bound, both equal to each other, no drops."""
    from bibim_tpu.scene.lights import make_lights
    from bibim_tpu.scene.scene import SceneData, batch_from_mesh

    cases.cap_threads()
    mesh = _standin()
    jscene = SceneData(batches=(batch_from_mesh(mesh),),
                       lights=make_lights([]))
    pscene = pgz.GizmoScene(device="cpu", mesh=mesh).scene_data()
    assert pscene.lights.num_lights == 0
    want, (full, prod, capped) = _frames(jscene, pscene)
    hit = full["tri_id"].numpy() >= 0
    assert 0.3 < hit.mean() < 0.9
    assert full["gbuffer"] == {}
    assert_image_bound(full["image"].numpy(), want)
    for out in (prod, capped):
        check_bin_diag(out["bin_diag"])
        assert torch.equal(out["image"], full["image"])
    rgb = full["image"].numpy()[hit]
    assert len(np.unique(rgb, axis=0)) > 100  # coloured and lit


def test_real_gizmo_frame_matches_jax():
    """GizmoScene() from the resource root's gizmo.obj in both
    packages."""
    from bibim_tpu.utils.config import get_resource_root

    if not get_resource_root().common("gizmo.obj").is_file():
        pytest.skip("gizmo.obj is not in the resource root")
    cases.cap_threads()
    jscene = jgz.GizmoScene().scene_data()
    pscene = pgz.GizmoScene(device="cpu").scene_data()
    # The whole mesh in a 256² frame: windows as wide as the JAX frame's
    # XLA raster bins.
    want, (full, prod, _) = _frames(jscene, pscene, max_candidates=2048)
    check_bin_diag(prod["bin_diag"])
    assert_image_bound(full["image"].numpy(), want)
    assert torch.equal(prod["image"], full["image"])
