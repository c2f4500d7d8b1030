"""The port's whole frame (bibim_tpu_torch.pipeline.render_frame) vs the JAX
package's render_frame on the CPU, on identical inputs carried across with
bibim_tpu_torch.interop; output modes, capacity validation, unsupported
settings, the shadow and IBL frames, and the ShaderBall golden images."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from bibim_tpu.ops import ibl as jibl
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import FRAME_BASE as BASE
from tests.torch_port_cases import assert_image_bound

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def inputs():
    return cases.frame_inputs()


@pytest.fixture(scope="module")
def jax_full(inputs):
    jin, _ = inputs
    out = jfg.render_frame(*jin, jfg.RenderSettings(outputs="full", **BASE))
    return jax.tree_util.tree_map(np.asarray, out)


def _port(inputs, **kw):
    return cases.port_frame(inputs, **kw)


_PRODUCTION = dict(outputs="image+diag", max_candidates=64, raster_passes=3,
                   live_tile_cap=31, raster_tile_cap=32, dense_tile_cap=16,
                   span_mid_cap=512)


@pytest.fixture(scope="module")
def without_fma():
    """The JAX frame rendered without FMAs, and the port's full and
    production renders of the same inputs (cases.frames_without_fma)."""
    return cases.frames_without_fma(
        "frame", {}, [dict(outputs="full"), _PRODUCTION])


def test_full_frame_matches_jax(inputs, jax_full, without_fma):
    out = _port(inputs, outputs="full")
    np.testing.assert_array_equal(out["tri_id"].numpy(), jax_full["tri_id"])
    hit = jax_full["tri_id"] >= 0
    assert 0.3 < hit.mean() < 0.9
    # Depth: the reference's CPU fallback divides (zn / wn) through
    # FMA-fused planes; the port keeps the kernel's zn * rcp(wn).
    np.testing.assert_allclose(out["depth"].numpy(), jax_full["depth"],
                               rtol=0, atol=1e-5)
    # 0.1038 % of pixels differ by one LSB (measured): XLA:CPU's FMA
    # differences carried across RGBA16F rounding boundaries
    # (tests/torch_port_cases.py NO_FMA_XLA_FLAGS); the cause is held
    # below against the JAX frame without FMAs.
    assert_image_bound(out["image"].numpy(), jax_full["image"], 1.29e-3)
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    for name in ("position", "normal", "albedo", "mrah", "matindex"):
        np.testing.assert_allclose(out["gbuffer"][name].numpy(),
                                   jax_full["gbuffer"][name], atol=2e-3)
    ref, (full, _) = without_fma
    cases.assert_rounding_crossings(full, ref)


def test_production_frame_matches_jax(inputs, jax_full, without_fma):
    """The kernel path (sampled shade, live-tile and pass-0 compaction,
    window passes, span-class binning) renders the reference image."""
    out = _port(inputs, **_PRODUCTION)
    check_bin_diag(out["bin_diag"])
    # 0.1068 % of pixels differ by one LSB (measured), for the cause named
    # in test_full_frame_matches_jax, held the same way.
    assert_image_bound(out["image"].numpy(), jax_full["image"], 1.33e-3)
    ref, (_, prod) = without_fma
    cases.assert_rounding_crossings(prod, ref, hdr_steps=4)
    plain = _port(inputs, outputs="image")
    assert_image_bound(out["image"].numpy(), plain["image"].numpy())


def test_undersized_capacities_are_reported(inputs):
    out = _port(inputs, outputs="image+diag", max_candidates=16,
                live_tile_cap=8, span_mid_cap=4)
    d = out["bin_diag"]
    assert int(d.dropped_cap) > 0 and int(d.dropped_tiles) > 0
    assert int(d.dropped_pairs) > 0
    with pytest.raises(AssertionError, match="raise"):
        check_bin_diag(d)


def test_output_modes(inputs):
    assert set(_port(inputs, outputs="image")) == {"image"}
    full = _port(inputs, outputs="full")
    assert set(full) == {"image", "ldr", "hdr", "depth", "tri_id",
                         "gbuffer", "bin_diag"}
    assert full["image"].shape == (cases.H, cases.W, 3)
    assert full["image"].dtype == torch.uint8
    assert torch.isfinite(full["hdr"]).all()


# Settings that raised before the port had forward lighting, anisotropic
# taps, the TBN view and the (T, 3) geometry, each now held against the
# JAX package's frame: (change, (full, production) image-bound fraction).
_PORTED = [
    (dict(deferred=False), (1e-3, 1e-3)),
    (dict(gbuffer_viz=1, deferred=False), (1e-3, 1e-3)),
    (dict(show_tbn=True), (1e-3, 1e-3)),
    (dict(enable_ibl=True, deferred=False), (1e-3, 1e-3)),
    # 0.116 / 0.119 % of pixels differ by one LSB (measured): XLA:CPU
    # contracts each tap's uv + t·du into an FMA and the taps' sum and the
    # G-buffer chain into more, the port rounds each operation; the 1-ulp
    # sample differences cross RGBA16F rounding boundaries as in
    # test_full_frame_matches_jax (the two-tap sample itself agrees within
    # 3e-7, tests/test_torch_aniso.py).
    (dict(aniso_taps=2), (1.25e-3, 1.25e-3)),
    # The port's (T, 3) frame is its planar frame bit for bit (below); it
    # is held against the JAX package's planar frame (``jax_full``) with
    # that frame's measured 0.1038 / 0.1068 % and cause
    # (test_full_frame_matches_jax, test_production_frame_matches_jax).
    # JAX's own (T, 3) frame: tests/test_torch_legacy.py.
    (dict(geometry="legacy"), (1.29e-3, 1.33e-3)),
    (dict(batch_material_ids=(0, 1), deferred=False), (1e-3, 1e-3)),
]


@pytest.mark.parametrize("change,frac", [
    pytest.param(c, f, id=next(iter(c))) for c, f in _PORTED])
def test_settings_match_jax(inputs, jax_full, change, frac):
    """Each setting through the port against the JAX package's frame: the
    plain chain ("full") and the compacted production path, zero drops,
    at the golden bound (or the fraction named above)."""
    jin, _ = inputs
    probe = jibl.make_ibl_sh()
    if "geometry" in change:
        want = jax_full["image"]
    else:
        want = np.asarray(jfg.render_frame(
            *jin, jfg.RenderSettings(outputs="image", **BASE, **change),
            ibl=probe)["image"])
    pibl = interop.ibl(probe, device="cpu")
    full = _port(inputs, ibl=pibl, outputs="full", **change)
    assert_image_bound(full["image"].numpy(), want, frac[0])
    prod = _port(inputs, ibl=pibl, **{**_PRODUCTION, **change})
    check_bin_diag(prod["bin_diag"])
    assert_image_bound(prod["image"].numpy(), want, frac[1])
    if "geometry" in change:
        for out, kw in ((full, dict(outputs="full")), (prod, _PRODUCTION)):
            planar = _port(inputs, **kw)["image"]
            assert torch.equal(out["image"], planar)


@pytest.mark.parametrize("change", [dict(raster="xla")],
                         ids=lambda c: next(iter(c)))
def test_unsupported_settings_raise(inputs, change):
    """The XLA fallback raster is not ported."""
    with pytest.raises(NotImplementedError):
        _port(inputs, outputs="image", **change)


def test_shadows_ibl_frame_matches_jax(inputs):
    """Deferred + shadows + analytic IBL (config 5's features) against the
    JAX package's render_frame, production path and plain chain."""
    cases.check_stretch_frame(inputs, dict(cases.SHADOWS, enable_ibl=True),
                              jibl.make_ibl_sh())


def test_stretch_capacities_are_reported(inputs):
    """An undersized shadow pass or PCF footprint reports drops."""
    out = _port(inputs, outputs="image+diag", shadow_candidates=8,
                shadow_query_tile_cap=2, **cases.SHADOWS)
    d = out["bin_diag"]
    assert int(d.dropped_cap) > 0 and int(d.dropped_tiles) > 0


def test_settings_carry_over():
    """RenderSettings has the JAX package's fields and defaults."""
    want = {f.name: f.default for f in dataclasses.fields(jfg.RenderSettings)}
    got = {f.name: f.default for f in dataclasses.fields(RenderSettings)}
    assert got == want
    s = jfg.RenderSettings(width=320, live_tile_cap=7, span_mid_cap=9)
    assert dataclasses.asdict(interop.render_settings(s)) == \
        dataclasses.asdict(s)


def test_shaderball_golden():
    """golden_configs' shaderball_pbr_192x96 through the port: the real
    ShaderBall.fbx, PBR material set and gizmo.obj (skips without them)."""
    from bibim_tpu.utils.config import get_resource_root

    root = get_resource_root()
    if not root.common("ShaderBall.fbx").is_file():
        pytest.skip("ShaderBall.fbx not found (resource root "
                    f"{root.common_root})")
    from PIL import Image

    from bibim_tpu.assets.materials import create_pbr_material_set
    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import (
        FrameParams,
        ViewBlock,
        make_overlay_resources,
        material_quads_from_set,
    )
    from bibim_tpu_torch.scene import FreeLookCamera
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    scene = ShaderBallScene(device="cpu")
    mats = material_quads_from_set(create_pbr_material_set(),
                                   scene.selected_material, device="cpu")
    cam = FreeLookCamera()
    vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix()),
                   proj=m3.perspective(60.0, 192 / 96, 0.1, 1000.0),
                   view_pos=torch.as_tensor(cam.pos),
                   enable_normal_map=torch.tensor(0, dtype=torch.int32))
    fp = FrameParams(torch.tensor(1, dtype=torch.int32),
                     torch.tensor(1.0, dtype=torch.float32))
    out = render_frame(
        scene.scene_data(), vb, fp, mats, make_overlay_resources(device="cpu"),
        # The reference's CPU fallback bins this frame with 2048
        # candidates per tile (golden_configs xla_cap); the port's windows
        # get the same room, the gizmo pass included.
        RenderSettings(width=192, height=96, max_candidates=2048,
                       overlay_candidates=2048, outputs="image+diag"))
    check_bin_diag(out["bin_diag"])
    want = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, "shaderball_pbr_192x96.png")))
    # The real assets are not in the repository, so this frame's fraction
    # has not been measured beside the others: it keeps the 0.25 % it was
    # held to before the golden 0.1 % became the default (ROADMAP queue 3).
    assert_image_bound(out["image"].numpy(), want, 2.5e-3)


def test_shaderball_shadows_ibl_golden():
    """golden_configs' shaderball_shadows_ibl_192x96 through the port: the
    real ShaderBall.fbx and PBR material set, shadow map fit to the ball,
    analytic IBL, normal map on (skips without the assets)."""
    from bibim_tpu.utils.config import get_resource_root

    root = get_resource_root()
    if not root.common("ShaderBall.fbx").is_file():
        pytest.skip("ShaderBall.fbx not found (resource root "
                    f"{root.common_root})")
    from PIL import Image

    from bibim_tpu.assets.materials import create_pbr_material_set
    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.pipeline import (
        FrameParams,
        ViewBlock,
        make_overlay_resources,
        material_quads_from_set,
    )
    from bibim_tpu_torch.scene import FreeLookCamera
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    scene = ShaderBallScene(device="cpu")
    mats = material_quads_from_set(create_pbr_material_set(),
                                   scene.selected_material, device="cpu")
    cam = FreeLookCamera()
    vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix()),
                   proj=m3.perspective(60.0, 192 / 96, 0.1, 1000.0),
                   view_pos=torch.as_tensor(cam.pos),
                   enable_normal_map=torch.tensor(1, dtype=torch.int32))
    fp = FrameParams(torch.tensor(1, dtype=torch.int32),
                     torch.tensor(1.0, dtype=torch.float32))
    out = render_frame(
        scene.scene_data(), vb, fp, mats, make_overlay_resources(device="cpu"),
        # Candidate room as the reference's CPU fallback bins it
        # (golden_configs xla_cap, shadow_candidates).
        RenderSettings(width=192, height=96, max_candidates=2048,
                       overlay_candidates=2048, enable_shadows=True,
                       enable_ibl=True, shadow_size=128,
                       shadow_candidates=4096,
                       shadow_fit_batches=scene.shadow_fit_batches,
                       outputs="image+diag"),
        ibl=make_ibl_sh(device="cpu"))
    check_bin_diag(out["bin_diag"])
    want = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, "shaderball_shadows_ibl_192x96.png")))
    # The real assets are not in the repository, so this frame's fraction
    # has not been measured beside the others: it keeps the 0.25 % it was
    # held to before the golden 0.1 % became the default (ROADMAP queue 3).
    assert_image_bound(out["image"].numpy(), want, 2.5e-3)
