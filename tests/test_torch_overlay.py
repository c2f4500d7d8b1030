"""Port overlay composite (K4's plain version, ops.fused.composite_overlay)
vs the JAX package's compact overlay kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.ops.raster import triangle_setup_planar as j_setup_planar
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu.scene.lights import make_lights
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.pipeline import framegraph as fg
from tests import torch_port_cases as cases


@pytest.fixture(scope="module")
def overlay_geometry():
    """The test scene as overlay geometry, JAX records and port records."""
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    soup = j_assemble(scene.batches, view, proj)
    setup = j_setup_planar(soup.clip, cases.W, cases.H)
    rec = jfused.build_record_table_planar(setup, soup)
    return view, proj, setup, rec


def _ldr(seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, (cases.NT, cases.TILE_H * cases.TILE_W))
                 .astype(np.float32) for _ in range(3))


def test_matches_pallas_interpret(overlay_geometry):
    _, _, setup, rec = overlay_geometry
    ldr3 = _ldr()
    zkey = np.zeros((cases.NT, cases.TILE_H * cases.TILE_W), np.int32)
    caps = dict(max_candidates=2048, overflow_cap=512, span_cap=128,
                max_tiles=cases.NT)
    want, wdiag = jfused.composite_overlay_pallas(
        rec, setup, tuple(map(jnp.asarray, ldr3)), jnp.asarray(zkey),
        cases.W, cases.H, tile_h=cases.TILE_H, tile_w=cases.TILE_W,
        interpret=True, **caps)
    got, diag = fused.composite_overlay(
        cases.record_table(rec), cases.planar_setup(setup),
        tuple(map(cases.t, ldr3)), cases.t(zkey), cases.W, cases.H,
        tile_h=cases.TILE_H, tile_w=cases.TILE_W, **caps)
    for a, b in zip(diag, wdiag):
        assert int(a) == int(b)
    changed = np.zeros(ldr3[0].shape, bool)
    for c in range(3):
        g, w = got[c].numpy(), np.asarray(want[c])
        # Same composited pixel set; colours within the reference test's
        # bound (XLA contracts the barycentric blend into FMAs).
        np.testing.assert_array_equal(g == ldr3[c], np.asarray(w) == ldr3[c])
        np.testing.assert_allclose(g, w, atol=1e-5)
        changed |= g != ldr3[c]
    assert changed.mean() > 0.3


def test_light_spheres_over_scene_depth(overlay_geometry):
    """Light spheres (the frame's overlay) continue the scene's depth keys:
    the port's sphere soup and composite match the JAX package's."""
    view, proj, setup, rec = overlay_geometry
    _, zkey, _ = fused.raster_fused(
        cases.record_table(rec), cases.planar_setup(setup), cases.W,
        cases.H, max_candidates=2048, overflow_cap=512, span_cap=128)
    from bibim_tpu.assets.meshgen import generate_uv_sphere_mesh

    sphere = generate_uv_sphere_mesh(0.1, 16, 16)
    jov = jfg.OverlayResources(
        sphere_positions=jnp.asarray(sphere.positions),
        sphere_tris=jnp.asarray(sphere.indices), gizmo_positions=None,
        gizmo_normals=None, gizmo_colors=None, gizmo_tris=None)
    jlights = make_lights([
        dict(type=0, pos=(0.3, 0.1, 2.2), color=(1, 0.2, 0.2)),
        dict(type=0, pos=(-0.4, -0.2, 3.1), color=(0.2, 1, 0.2)),
        dict(type=0, pos=(1.0, 0.3, 4.5), color=(0.2, 0.2, 1)),
    ])
    jvp = jnp.matmul(proj, view)
    jsoup = jfg._light_sphere_planar_soup(jlights, jov, jvp)
    soup = fg._light_sphere_planar_soup(
        interop.lights(jlights), interop.overlay_resources(jov),
        cases.t(jvp))
    for a, b in zip(torch.cat([torch.stack(c) for c in soup.clip]),
                    np.concatenate([np.stack(c) for c in jsoup.clip])):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    jsetup = j_setup_planar(jsoup.clip, cases.W, cases.H)
    jrec = jfused.build_record_table_planar(jsetup, jsoup)
    ldr3 = _ldr(4)
    caps = dict(max_candidates=384, overflow_cap=512, span_cap=32,
                max_tiles=cases.NT, span_mid_cap=max(256, jrec.shape[0] // 4))
    want, wdiag = jfused.composite_overlay_pallas(
        jrec, jsetup, tuple(map(jnp.asarray, ldr3)),
        jnp.asarray(zkey.numpy()), cases.W, cases.H, interpret=True, **caps)
    got, diag = fused.composite_overlay(
        cases.record_table(jrec), cases.planar_setup(jsetup),
        tuple(map(cases.t, ldr3)), zkey, cases.W, cases.H, **caps)
    for a, b in zip(diag, wdiag):
        assert int(a) == int(b)
    n_changed = 0
    for c in range(3):
        g, w = got[c].numpy(), np.asarray(want[c])
        np.testing.assert_array_equal(g == ldr3[c], w == ldr3[c])
        np.testing.assert_allclose(g, w, atol=1e-5)
        n_changed += int((g != ldr3[c]).sum())
    assert n_changed > 0
    # A compact list sized to the few sphere tiles composites exactly what
    # the full-size list (mostly dead padding slots) does.
    tight, tdiag = fused.composite_overlay(
        cases.record_table(jrec), cases.planar_setup(jsetup),
        tuple(map(cases.t, ldr3)), zkey, cases.W, cases.H,
        **{**caps, "max_tiles": 12})
    assert int(tdiag.dropped_tiles) == 0
    for a, b in zip(got, tight):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dropped_tiles_are_counted(overlay_geometry):
    _, _, setup, rec = overlay_geometry
    ldr3 = tuple(map(cases.t, _ldr()))
    zkey = torch.zeros((cases.NT, cases.TILE_H * cases.TILE_W),
                       dtype=torch.int32)
    _, diag = fused.composite_overlay(
        cases.record_table(rec), cases.planar_setup(setup), ldr3, zkey,
        cases.W, cases.H, max_candidates=2048, overflow_cap=512,
        span_cap=128, max_tiles=2)
    assert int(diag.dropped_tiles) > 0
