"""The port's whole frame (bibim_tpu_torch.pipeline.render_frame) vs the JAX
package's render_frame on the CPU, on identical inputs carried across with
bibim_tpu_torch.interop; output modes, capacity validation, unsupported
settings, and the ShaderBall golden image."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.assets.meshgen import (
    generate_cube_mesh,
    generate_uv_sphere_mesh,
)
from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

BASE = dict(width=cases.W, height=cases.H, max_candidates=512,
            overflow_cap=64, span_cap=64, xla_cap=2048, gizmo_extent=40)


def assert_image_bound(got, want, frac_max=2.5e-3):
    """The golden-image bound (≤2 LSB, tests/test_goldens.py) with room
    for XLA:CPU's FMA contraction: the JAX reference fuses a*b+c, the port
    rounds each operation, which moves ~0.04-0.11% of this frame's pixels
    by one LSB (measured); 0.25% bounds that."""
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    frac = (d > 0).any(axis=-1).mean()
    assert d.max() <= 2, d.max()
    assert frac <= frac_max, frac


@pytest.fixture(scope="module")
def inputs():
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    mats = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    sphere = generate_uv_sphere_mesh(0.1, 16, 16)
    cube = generate_cube_mesh(1.0)  # stands in for gizmo.obj
    overlay = jfg.OverlayResources(
        sphere_positions=jnp.asarray(sphere.positions),
        sphere_tris=jnp.asarray(sphere.indices),
        gizmo_positions=jnp.asarray(cube.positions),
        gizmo_normals=jnp.asarray(cube.normals),
        gizmo_colors=jnp.asarray(np.abs(cube.normals)),
        gizmo_tris=jnp.asarray(cube.indices))
    vb = jfg.ViewBlock(view=view, proj=proj, view_pos=jnp.zeros(3),
                       enable_normal_map=jnp.int32(1))
    fp = jfg.FrameParams(enable_tone_mapping=jnp.int32(1),
                         exposure=jnp.float32(1.0))
    port = (interop.scene_data(scene), interop.view_block(vb),
            interop.frame_params(fp), interop.material_tables(mats),
            interop.overlay_resources(overlay))
    return (scene, vb, fp, mats, overlay), port


@pytest.fixture(scope="module")
def jax_full(inputs):
    jin, _ = inputs
    out = jfg.render_frame(*jin, jfg.RenderSettings(outputs="full", **BASE))
    return jax.tree_util.tree_map(np.asarray, out)


def _port(inputs, **kw):
    _, pin = inputs
    return render_frame(*pin, RenderSettings(**{**BASE, **kw}))


def test_full_frame_matches_jax(inputs, jax_full):
    out = _port(inputs, outputs="full")
    np.testing.assert_array_equal(out["tri_id"].numpy(), jax_full["tri_id"])
    hit = jax_full["tri_id"] >= 0
    assert 0.3 < hit.mean() < 0.9
    # Depth: the reference's CPU fallback divides (zn / wn) through
    # FMA-fused planes; the port keeps the kernel's zn * rcp(wn).
    np.testing.assert_allclose(out["depth"].numpy(), jax_full["depth"],
                               rtol=0, atol=1e-5)
    assert_image_bound(out["image"].numpy(), jax_full["image"])
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    for name in ("position", "normal", "albedo", "mrah", "matindex"):
        np.testing.assert_allclose(out["gbuffer"][name].numpy(),
                                   jax_full["gbuffer"][name], atol=2e-3)


def test_production_frame_matches_jax(inputs, jax_full):
    """The kernel path (sampled shade, live-tile and pass-0 compaction,
    window passes, span-class binning) renders the reference image."""
    out = _port(inputs, outputs="image+diag", max_candidates=64,
                raster_passes=3, live_tile_cap=31, raster_tile_cap=32,
                dense_tile_cap=16, span_mid_cap=512)
    check_bin_diag(out["bin_diag"])
    assert_image_bound(out["image"].numpy(), jax_full["image"])
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


@pytest.mark.parametrize("change", [
    dict(deferred=False), dict(shading="flat"), dict(gbuffer_viz=1),
    dict(show_tbn=True), dict(show_hud=True), dict(enable_shadows=True),
    dict(enable_ibl=True), dict(aniso_taps=2), dict(pair_sampling=2),
    dict(early_z=True), dict(fine_bins=True), dict(group_pair_cap=512),
    dict(merged_coverage=True), dict(raster="xla"),
    dict(geometry="legacy"), dict(batch_material_ids=(0,)),
], ids=lambda c: next(iter(c)))
def test_unsupported_settings_raise(inputs, change):
    with pytest.raises(NotImplementedError):
        _port(inputs, outputs="image", **change)


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

    scene = ShaderBallScene()
    mats = material_quads_from_set(create_pbr_material_set(),
                                   scene.selected_material)
    cam = FreeLookCamera()
    vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix()),
                   proj=m3.perspective(60.0, 192 / 96, 0.1, 1000.0),
                   view_pos=torch.as_tensor(cam.pos),
                   enable_normal_map=torch.tensor(0, dtype=torch.int32))
    fp = FrameParams(torch.tensor(1, dtype=torch.int32),
                     torch.tensor(1.0, dtype=torch.float32))
    out = render_frame(
        scene.scene_data(), vb, fp, mats, make_overlay_resources(),
        # The reference's CPU fallback bins this frame with 2048
        # candidates per tile (golden_configs xla_cap); the port's windows
        # get the same room, the gizmo pass included.
        RenderSettings(width=192, height=96, max_candidates=2048,
                       overlay_candidates=2048, outputs="image+diag"))
    check_bin_diag(out["bin_diag"])
    want = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, "shaderball_pbr_192x96.png")))
    assert_image_bound(out["image"].numpy(), want)
