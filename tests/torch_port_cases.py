"""Shared inputs of the port's CPU tests (tests/test_torch_*.py): one small
scene built with the JAX package — a UV sphere in front of the camera over
the 100× ground plane, the ShaderBall lights — and seeded numpy material
maps, plus helpers that carry the JAX package's arrays into the port
(through numpy, as bibim_tpu_torch.interop does).

XLA on the CPU contracts ``a*b + c`` into fused multiply-adds inside its
fusions; the port, like the TPU kernels it replaces, rounds every product
and sum. Float arrays the two compute independently therefore agree to a
few ulps rather than bit for bit; integer results (triangle ids, depth
keys, binning) and arrays that are pure data movement agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

W, H = 256, 128
TILE_H, TILE_W = 8, 128
TX = W // TILE_W
NT = (H // TILE_H) * TX

# Settings of the whole-frame comparisons (tests/test_torch_frame.py and
# the shadow / IBL frames).
FRAME_BASE = dict(width=W, height=H, max_candidates=512, overflow_cap=64,
                  span_cap=64, xla_cap=2048, gizmo_extent=40)
# The shadow map of the stretch frames is fit to the sphere (batch 0), as
# BASELINE config 5 fits it to the ball: a map spread over the 100× plane
# puts the sphere's self-shadow test within an ulp of its own depth, where
# XLA:CPU's fused FMAs flip PCF taps (ROADMAP queue 3).
SHADOWS = dict(enable_shadows=True, shadow_size=256, shadow_fit_batches=(0,))


def cap_threads() -> None:
    """Several test workers share the machine with JAX."""
    torch.set_num_threads(2)


def jax_scene():
    """(SceneData, view, proj) of the test scene, JAX package types."""
    import jax.numpy as jnp

    from bibim_tpu import math3d as m3
    from bibim_tpu.assets.meshgen import (
        generate_plane_mesh,
        generate_uv_sphere_mesh,
    )
    from bibim_tpu.scene.camera import FreeLookCamera
    from bibim_tpu.scene.scene import SceneData, batch_from_mesh
    from bibim_tpu.scene.shaderball import shaderball_lights

    sphere = generate_uv_sphere_mesh(1.0, 24, 16)
    model = np.asarray(m3.translate([0.0, -0.3, 3.0]))
    plane_model = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane_model[1, 3] = -1.5
    scene = SceneData(
        batches=(batch_from_mesh(sphere, model),
                 batch_from_mesh(generate_plane_mesh(), plane_model)),
        lights=shaderball_lights(),
    )
    view = jnp.asarray(FreeLookCamera().get_view_matrix())
    proj = m3.perspective(60.0, W / H, 0.1, 1000.0)
    return scene, view, proj


def material_maps(seed: int = 0) -> dict:
    """Seeded u8 maps: 64² metallic/roughness/ao (a block table at
    block_threshold=1024) and 16² albedo/normal/height (a quad table)."""
    rng = np.random.default_rng(seed)

    def m(n):
        return rng.integers(0, 256, (n, n, 1), dtype=np.uint8)

    maps = {s: m(64) for s in ("metallic", "roughness", "ao")}
    maps.update({s: m(16) for s in ("alb_r", "alb_g", "alb_b", "nrm_x",
                                   "nrm_y", "nrm_z", "height")})
    return maps


def t(x, dtype=None) -> torch.Tensor:
    out = torch.as_tensor(np.array(np.asarray(x), copy=True))
    return out if dtype is None else out.to(dtype)


def planar_setup(js):
    """The JAX package's PlanarSetup as the port's."""
    from bibim_tpu_torch.ops.raster import PlanarSetup

    def tup(x):
        return tuple(t(c) for c in x)

    return PlanarSetup(
        edge_a=tup(js.edge_a), edge_b=tup(js.edge_b), edge_c=tup(js.edge_c),
        z_coef=tup(js.z_coef), w_coef=tup(js.w_coef),
        bbox=tuple(t(c, torch.int32) for c in js.bbox),
        valid=t(js.valid, torch.bool),
        zub=None if js.zub is None else t(js.zub))


def record_table(jrec) -> torch.Tensor:
    """(T, 128) JAX records → the port's (T, 64) rows (60 used channels)."""
    from bibim_tpu_torch.ops.fused import REC_CH, _USED

    r = np.asarray(jrec)
    assert not r[:, _USED:].any()
    return t(r[:, :REC_CH]).contiguous()


def ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps between two float32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, (-(1 << 31)) - ia, ia)
    ib = np.where(ib < 0, (-(1 << 31)) - ib, ib)
    return np.abs(ia - ib)


def assert_shade_close(want, got):
    """tests/test_shading_pallas.py _assert_close: ≤0.1 % of values off
    by more than 5e-5, none by 2e-3 (fp16 rounding boundaries crossed by
    1-ulp FMA differences)."""
    for c in range(3):
        diff = np.abs(np.asarray(want[c]) - np.asarray(got[c]))
        assert (diff > 5e-5).mean() < 1e-3, diff.max()
        assert diff.max() < 2e-3, diff.max()


def assert_image_bound(got, want, frac_max=2.5e-3):
    """The golden-image bound (≤2 LSB, tests/test_goldens.py) with room
    for XLA:CPU's FMA contraction: the JAX reference fuses a*b+c, the port
    rounds each operation, which moves ~0.04-0.11% of this frame's pixels
    by one LSB (measured); 0.25% bounds that."""
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    frac = (d > 0).any(axis=-1).mean()
    assert d.max() <= 2, d.max()
    assert frac <= frac_max, frac


def frame_inputs():
    """((JAX scene, view block, frame params, tables, overlay), the same
    carried into the port): the test scene, seeded maps, light spheres and
    a cube standing in for gizmo.obj."""
    import jax.numpy as jnp

    from bibim_tpu.assets.meshgen import (
        generate_cube_mesh,
        generate_uv_sphere_mesh,
    )
    from bibim_tpu.ops import texture_quad as jtq
    from bibim_tpu.pipeline import framegraph as jfg
    from bibim_tpu_torch import interop

    cap_threads()
    scene, view, proj = jax_scene()
    mats = jtq.build_quad_tables(material_maps(), block_threshold=1024)
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
    port = (interop.scene_data(scene, device="cpu"),
            interop.view_block(vb, device="cpu"),
            interop.frame_params(fp, device="cpu"),
            interop.material_tables(mats, device="cpu"),
            interop.overlay_resources(overlay, device="cpu"))
    return (scene, vb, fp, mats, overlay), port


def port_frame(inputs, ibl=None, **kw):
    """The port's render_frame of :func:`frame_inputs` at FRAME_BASE."""
    from bibim_tpu_torch.pipeline import RenderSettings, render_frame

    _, pin = inputs
    return render_frame(*pin, RenderSettings(**{**FRAME_BASE, **kw}),
                        ibl=ibl)


def check_stretch_frame(inputs, kw: dict, jibl=None) -> None:
    """A deferred frame with shadows and/or IBL (``kw``; ``jibl`` the JAX
    package's probe) against the JAX package's render_frame: the plain
    chain ("full"), and the production path — the shadow pass on K1, PCF
    compacted to the frustum footprint, K2 with the visibility plane or
    K6/K7 sampling + IBL ambient + K5 — with compacted capacities, zero
    drops, at the image bound."""
    from bibim_tpu.pipeline import framegraph as jfg
    from bibim_tpu_torch import interop
    from bibim_tpu_torch.utils.validation import check_bin_diag

    jin, _ = inputs
    want_img = np.asarray(jfg.render_frame(
        *jin, jfg.RenderSettings(outputs="image", **FRAME_BASE, **kw),
        ibl=jibl)["image"])
    pibl = interop.ibl(jibl, device="cpu") if jibl is not None else None
    full = port_frame(inputs, ibl=pibl, outputs="full", **kw)
    assert_image_bound(full["image"].numpy(), want_img)
    prod = port_frame(inputs, ibl=pibl, outputs="image+diag",
                      max_candidates=64, raster_passes=3, live_tile_cap=31,
                      raster_tile_cap=32, shadow_tile_cap=64,
                      shadow_query_tile_cap=24, **kw)
    check_bin_diag(prod["bin_diag"])
    assert_image_bound(prod["image"].numpy(), want_img)
    baseline = port_frame(inputs, outputs="image")["image"].numpy()
    assert not np.array_equal(prod["image"].numpy(), baseline)


def instanced_scene(n: int = 6):
    """(SceneData, view, proj), JAX package types, of a config-4-like test
    frame: ``n`` small UV-sphere instances (480 triangles each, 2-4 px
    triangles at this size) in a row receding from the camera, over the
    100× ground plane, with the ShaderBall lights."""
    import jax.numpy as jnp

    from bibim_tpu import math3d as m3
    from bibim_tpu.assets.meshgen import (
        generate_plane_mesh,
        generate_uv_sphere_mesh,
    )
    from bibim_tpu.scene.camera import FreeLookCamera
    from bibim_tpu.scene.scene import SceneData, batch_from_mesh
    from bibim_tpu.scene.shaderball import shaderball_lights

    sphere = generate_uv_sphere_mesh(0.35, 20, 12)
    models = np.stack([np.asarray(m3.translate([-1.1 + 0.45 * i, -0.2,
                                                2.4 + 0.7 * i]))
                       for i in range(n)]).astype(np.float32)
    plane_model = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane_model[1, 3] = -1.5
    scene = SceneData(
        batches=(batch_from_mesh(sphere, models),
                 batch_from_mesh(generate_plane_mesh(), plane_model)),
        lights=shaderball_lights(),
    )
    view = jnp.asarray(FreeLookCamera().get_view_matrix())
    proj = m3.perspective(60.0, W / H, 0.1, 1000.0)
    return scene, view, proj


def jax_pass_of(scene, view, proj):
    """(JAX setup, JAX records, port setup, port records) of a scene's main
    pass at the test size."""
    from bibim_tpu.ops import fused as jfused
    from bibim_tpu.ops.geometry import assemble_scene_planar
    from bibim_tpu.ops.raster import triangle_setup_planar

    soup = assemble_scene_planar(scene.batches, view, proj)
    setup = triangle_setup_planar(soup.clip, W, H)
    rec = jfused.build_record_table_planar(setup, soup)
    return setup, rec, planar_setup(setup), record_table(rec)


def assert_raster_close(got, want):
    """A port raster (pixels, zkey, diag) against the JAX package's: tri ids
    and every BinDiag count equal, depth keys within K1's stated bound
    (XLA:CPU's FMA contraction moves < 1 % of keys by ≤ 3 quanta;
    tests/test_torch_raster.py)."""
    px, zk, diag = got
    px_j, zk_j, diag_j = want
    np.testing.assert_array_equal(px.tri_id.numpy(), np.asarray(px_j.tri_id))
    zd = np.abs(zk.numpy().astype(np.int64) - np.asarray(zk_j))
    assert (zd > 0).mean() < 0.01 and zd.max() <= 32, (zd > 0).mean()
    for a, b in zip(diag, diag_j):
        assert int(a) == int(b)


def assert_raster_equal(a, b):
    """Two port rasters bit for bit: every pixel plane and the keys."""
    px_a, zk_a, _ = a
    px_b, zk_b, _ = b
    np.testing.assert_array_equal(zk_a.numpy(), zk_b.numpy())

    def leaves(px):
        return [c for f in px for c in (f if isinstance(f, tuple) else (f,))]

    for x, y in zip(leaves(px_a), leaves(px_b)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
