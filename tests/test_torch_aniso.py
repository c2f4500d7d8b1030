"""Anisotropic taps (``aniso_taps`` > 1) in the port against the JAX
package on the CPU: ``aniso_uv_steps``, the N-tap material sample over
quad, block, mip-block and image-space bindings (each tap one call of the
G-buffer samplers: K6 / K7 / K8), the cube frame at 2 taps, and the
``shaderball_aniso2_192x96`` golden (skips without the assets)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.pipeline import KERNELS, Kernels, RenderSettings
from bibim_tpu_torch.pipeline import framegraph as fg
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.test_torch_cube import BASE as CUBE_BASE
from tests.test_torch_cube import PROD as CUBE_PROD
from tests.test_torch_cube import _albedos, _jax_cube_tables

TILE_H, TILE_W = 8, 128
TX, NT = 2, 6


def _pixels(seed: int):
    return cases.seeded_pixels(seed, NT, TX)


def _settings(**kw):
    return (jfg.RenderSettings(width=TX * TILE_W, height=24, **kw),
            RenderSettings(width=TX * TILE_W, height=24, **kw))


@pytest.fixture(scope="module")
def bindings():
    """name → (JAX binding, port binding): the seeded block + quad tables,
    the merged mip-block cube tables, and image-space MaterialTextures."""
    cases.cap_threads()
    jt = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    jm = _jax_cube_tables(_albedos())
    maps = cases.material_maps(5)

    def rgba(*keys):
        a = np.concatenate([maps[k] for k in keys], -1)
        return np.concatenate(
            [a, np.full(a.shape[:2] + (4 - a.shape[2],), 255, np.uint8)], -1)

    jtex = jfg.MaterialTextures(
        albedo=jnp.asarray(rgba("alb_r", "alb_g", "alb_b")),
        metallic=jnp.asarray(rgba("metallic")),
        roughness=jnp.asarray(rgba("roughness")), ao=jnp.asarray(rgba("ao")),
        normal=jnp.asarray(rgba("nrm_x", "nrm_y", "nrm_z")),
        height=jnp.asarray(rgba("height")))
    return {name: (j, interop.materials(j, device="cpu"))
            for name, j in (("tables", jt), ("mip_block", jm),
                            ("textures", jtex))}


def _spy(calls: dict) -> Kernels:
    def wrap(name, fn):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return run

    return Kernels(*(wrap(n, f) for n, f in zip(Kernels._fields, KERNELS)))


@pytest.mark.parametrize("seed", [0, 1])
def test_aniso_uv_steps_match_jax(seed):
    """The major-axis uv step, bit for bit (both sides round each
    operation: the JAX function runs op by op here)."""
    jpx, ppx = _pixels(seed)
    want = jtq.aniso_uv_steps(*jpx.uv, TILE_H, TILE_W)
    got = tq.aniso_uv_steps(*ppx.uv, TILE_H, TILE_W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Both axes are picked somewhere.
    du_dx = tq._quad_diffs_planar(ppx.uv[0], TILE_H, TILE_W)[0]
    assert 0.1 < float((got[0] == du_dx).float().mean()) < 0.9


@pytest.mark.parametrize("binding,taps", [("tables", 2), ("tables", 4),
                                          ("mip_block", 2), ("textures", 3)])
def test_aniso_sample_matches_jax(bindings, binding, taps):
    """The N-tap slot planes against the JAX package's ``_sample_materials``
    (its XLA samplers), through the plain XLA-order samplers and through
    the sampler kernels' entry points (K6 / K7 / K8, plain versions on the
    CPU): the taps summed in order, then × 1/N, within the samplers'
    3e-7 bound (tests/test_torch_sampling.py). Each tap is one call of
    each table's sampler."""
    jb, pb = bindings[binding]
    jpx, ppx = _pixels(7)
    js, ps = _settings(aniso_taps=taps)
    want = jfg._sample_materials(jb, jpx, js)
    one = fg._sample_materials(pb, ppx, dataclasses.replace(ps, aniso_taps=1),
                               None)
    calls = {}
    for kernels in (None, _spy(calls)):
        got = fg._sample_materials(pb, ppx, ps, kernels)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=3e-7, atol=3e-7, err_msg=k)
    assert any(not torch.equal(got[k], one[k]) for k in got)
    expect = {"tables": {"sample_block": taps, "sample_small": taps},
              "mip_block": {"sample_mip_block": taps, "sample_small": taps},
              "textures": {}}[binding]
    assert calls == expect


def test_aniso_cube_frame_matches_jax():
    """The config-2 cube frame at 2 taps: the plain chain and the compacted
    production frame (K8 and K7 twice each, then K5; no K2) against the
    JAX package's render_frame, at the golden bound."""
    from bibim_tpu.scene.camera import FreeLookCamera as JCamera
    from bibim_tpu.scene.cube import CubeScene as JCubeScene
    from bibim_tpu import math3d as jm3

    cases.cap_threads()
    w, h = CUBE_BASE["width"], CUBE_BASE["height"]
    cam = JCamera()
    vb = jfg.ViewBlock(view=jnp.asarray(cam.get_view_matrix()),
                       proj=jm3.perspective(60.0, w / h, 0.1, 1000.0),
                       view_pos=jnp.asarray(cam.pos),
                       enable_normal_map=jnp.int32(0))
    fp = jfg.FrameParams(enable_tone_mapping=jnp.int32(1),
                         exposure=jnp.float32(1.0))
    jin = (JCubeScene().scene_data(), vb, fp, _jax_cube_tables(_albedos()))
    want = np.asarray(jfg.render_frame(*jin, None, jfg.RenderSettings(
        outputs="image", aniso_taps=2, **CUBE_BASE))["image"])
    pin = (interop.scene_data(jin[0], device="cpu"),
           interop.view_block(vb, device="cpu"),
           interop.frame_params(fp, device="cpu"),
           interop.materials(jin[3], device="cpu"))
    full = fg.render_frame(*pin, None, RenderSettings(
        **CUBE_BASE, outputs="full", aniso_taps=2))
    cases.assert_image_bound(full["image"].numpy(), want)
    calls = {}
    prod = fg.render_frame(*pin, None, RenderSettings(
        **{**CUBE_BASE, **CUBE_PROD}, outputs="image+diag", aniso_taps=2),
        kernels=_spy(calls))
    check_bin_diag(prod["bin_diag"])
    cases.assert_image_bound(prod["image"].numpy(), want)
    assert calls["sample_mip_block"] == 2 and calls["sample_small"] == 2
    assert calls["shade_gbuffer"] == 1 and "shade" not in calls
    one = fg.render_frame(*pin, None, RenderSettings(**CUBE_BASE,
                                                     outputs="image"))
    assert not np.array_equal(one["image"].numpy(), prod["image"].numpy())


def test_shaderball_aniso2_golden():
    """golden_configs' shaderball_aniso2_192x96 through the port: the real
    ShaderBall.fbx and PBR material set 0, the grazing camera, 2 taps
    (skips without the assets)."""
    from bibim_tpu.utils.config import get_resource_root

    root = get_resource_root()
    if not root.common("ShaderBall.fbx").is_file():
        pytest.skip("ShaderBall.fbx not found (resource root "
                    f"{root.common_root})")
    from bibim_tpu.assets.materials import create_pbr_material_set
    from bibim_tpu_torch.pipeline import material_quads_from_set
    from bibim_tpu_torch.scene import FreeLookCamera
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    scene = ShaderBallScene(device="cpu")
    mats = material_quads_from_set(create_pbr_material_set(), 0,
                                   device="cpu")
    cam = FreeLookCamera(pos=np.array([0.0, 0.35, -5.0], np.float32),
                         pitch=-2.0)
    out = fg.render_frame(
        scene.scene_data(), cases.golden_view(192, 96, cam),
        cases.golden_params(), mats, None,
        # Candidate room as the reference's CPU fallback bins this frame
        # (golden_configs xla_cap).
        RenderSettings(width=192, height=96, max_candidates=2048,
                       overlay_candidates=2048, aniso_taps=2,
                       show_gizmo=False, show_lights=False,
                       outputs="image+diag"))
    check_bin_diag(out["bin_diag"])
    # The assets are not in the repository, so this frame's fraction has
    # not been measured beside the others: it is held to the 0.25 % of the
    # other ShaderBall goldens (tests/test_torch_frame.py).
    cases.assert_image_bound(out["image"].numpy(),
                             cases.golden_png("shaderball_aniso2_192x96"),
                             2.5e-3)

