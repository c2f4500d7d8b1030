"""Port raster (K1's plain version, ops.fused.raster_fused) vs the JAX
package's Pallas raster kernel in interpret mode, on identical setups and
record tables; plus triangle setup and record-table builds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.ops.raster import triangle_setup as j_setup_indexed
from bibim_tpu.ops.raster import triangle_setup_planar as j_setup_planar
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops.geometry import assemble_scene_planar
from bibim_tpu_torch.ops.raster import triangle_setup, triangle_setup_planar
from bibim_tpu_torch import interop
from tests import torch_port_cases as cases

CAPS = dict(max_candidates=2048, overflow_cap=512, span_cap=128)


@pytest.fixture(scope="module")
def jax_pass():
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    soup = j_assemble(scene.batches, view, proj)
    setup = j_setup_planar(soup.clip, cases.W, cases.H)
    rec = jfused.build_record_table_planar(setup, soup)
    return scene, view, proj, soup, setup, rec


@pytest.fixture(scope="module")
def pallas_out(jax_pass):
    _, _, _, _, setup, rec = jax_pass
    return jfused.raster_fused_pallas(
        rec, setup, cases.W, cases.H, tile_h=cases.TILE_H,
        tile_w=cases.TILE_W, interpret=True, **CAPS)


def _port_raster(jax_pass, **kw):
    *_, setup, rec = jax_pass
    args = dict(tile_h=cases.TILE_H, tile_w=cases.TILE_W, **CAPS)
    args.update(kw)
    return fused.raster_fused(cases.record_table(rec),
                              cases.planar_setup(setup), cases.W, cases.H,
                              **args)


def test_record_table_bit_equal(jax_pass):
    """Same setup and soup in → the same record rows out."""
    *_, soup, setup, rec = jax_pass

    def tup(x):
        return tuple(tup(c) for c in x) if isinstance(x, tuple) else \
            cases.t(x)

    from bibim_tpu_torch.ops.geometry import PlanarSoup

    psoup = PlanarSoup(*(tup(getattr(soup, f)) for f in PlanarSoup._fields))
    got = fused.build_record_table_planar(cases.planar_setup(setup), psoup)
    np.testing.assert_array_equal(got.numpy(), cases.record_table(rec))


def test_setup_matches_jax(jax_pass):
    """Port setup from the JAX clip planes: culling and bbox exactly equal,
    coefficients within a few ulps (XLA contracts a*b+c on the CPU)."""
    *_, soup, setup, _ = jax_pass
    clip = tuple(tuple(cases.t(c) for c in k) for k in soup.clip)
    got = triangle_setup_planar(clip, cases.W, cases.H)
    valid = np.asarray(setup.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for a, b in zip(got.bbox, setup.bbox):
        np.testing.assert_array_equal(a.numpy()[valid], np.asarray(b)[valid])
    for name in ("edge_a", "edge_b", "edge_c", "z_coef", "w_coef"):
        for a, b in zip(getattr(got, name), getattr(setup, name)):
            a, b = a.numpy()[valid], np.asarray(b)[valid]
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_indexed_setup_matches_planar():
    """The gizmo's indexed setup and the planar setup agree on the same
    triangles (one formula in the port)."""
    from bibim_tpu.assets.meshgen import generate_cube_mesh
    from bibim_tpu import math3d as m3

    cube = generate_cube_mesh(1.0)
    vp = np.asarray(m3.matmul(m3.perspective(40.0, 1.0, 0.1, 100.0),
                              m3.translate([0.2, -0.1, 3.0])))
    p4 = np.concatenate([cube.positions, np.ones((len(cube.positions), 1),
                                                 np.float32)], 1)
    clip = (p4 @ vp.T).astype(np.float32)
    tris = cube.indices
    js = j_setup_indexed(jnp.asarray(clip), jnp.asarray(tris), 64, 64)
    got = triangle_setup(cases.t(clip), cases.t(tris), 64, 64)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(js.valid))
    for k in range(4):
        np.testing.assert_array_equal(got.bbox[k].numpy(),
                                      np.asarray(js.bbox[:, k]))
    for k in range(3):
        np.testing.assert_allclose(got.edge_a[k].numpy(),
                                   np.asarray(js.edge_a[:, k]),
                                   rtol=2e-5, atol=2e-6)


def test_matches_pallas_interpret(jax_pass, pallas_out):
    px_p, zk_p, diag_p = pallas_out
    px, zk, diag = _port_raster(jax_pass)
    assert int(diag.dropped_cap) == 0 and int(diag.dropped_overflow) == 0
    np.testing.assert_array_equal(px.tri_id.numpy(), np.asarray(px_p.tri_id))
    # Depth keys: the interpreted kernel runs through XLA:CPU, which fuses
    # A*px + B*py + C into FMAs; the port rounds each product and sum (as
    # the TPU kernel and the CUDA kernel do). z then moves by an ulp or two
    # on some pixels, and a masked key by one 8-ulp quantum where that
    # crosses a quantum boundary (measured: 124 of 32768 pixels, ≤3
    # quanta).
    zd = np.abs(zk.numpy().astype(np.int64) - np.asarray(zk_p))
    assert (zd > 0).mean() < 0.01 and zd.max() <= 32, (zd > 0).mean()
    hit = np.asarray(px_p.tri_id) >= 0
    assert hit.mean() > 0.3
    # test_fused.py's Pallas-vs-XLA bounds.
    for name in ("uv", "normal", "tangent", "world", "color", "bary"):
        for a, b in zip(getattr(px, name), getattr(px_p, name)):
            np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                       atol=1e-3)
    np.testing.assert_allclose(px.depth.numpy()[hit],
                               np.asarray(px_p.depth)[hit], atol=1e-5)
    for a, b in zip(diag, diag_p):
        assert int(a) == int(b)


def test_multipass_and_compaction_are_exact(jax_pass):
    """Window passes + pass-0 and dense-pass compaction reproduce the
    single-pass raster bit for bit (GEQ chaining keeps draw order)."""
    px_a, zk_a, _ = _port_raster(jax_pass)
    px_b, zk_b, diag = _port_raster(
        jax_pass, max_candidates=96, passes=4, raster_tile_cap=cases.NT,
        dense_tile_cap=16)
    for k in range(4):
        assert int(diag[k]) == 0
    np.testing.assert_array_equal(zk_a.numpy(), zk_b.numpy())
    def leaves(px):
        return [c for f in px for c in (f if isinstance(f, tuple) else (f,))]

    for a, b in zip(leaves(px_a), leaves(px_b)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_drop_fields_zero_the_pruned_planes(jax_pass):
    px, zk, _ = _port_raster(jax_pass, drop_fields=("depth", "cr", "b0"))
    px_all, zk_all, _ = _port_raster(jax_pass)
    np.testing.assert_array_equal(zk.numpy(), zk_all.numpy())
    assert not px.depth.any() and not px.color[0].any()
    np.testing.assert_array_equal(px.uv[0].numpy(), px_all.uv[0].numpy())


def test_init_zkey_continues_depth(jax_pass):
    """Re-rastering the same geometry against its own keys re-wins every
    pixel (>= keeps ties)."""
    px, zk, _ = _port_raster(jax_pass)
    px2, zk2, _ = _port_raster(jax_pass, init_zkey=zk)
    np.testing.assert_array_equal(px2.tri_id.numpy(), px.tri_id.numpy())
    np.testing.assert_array_equal(zk2.numpy(), zk.numpy())


def test_port_assembly_rasters_like_jax(jax_pass, pallas_out):
    """The port's own vertex stage + setup + records: same triangle ids as
    the JAX kernel on every pixel."""
    scene, view, proj, *_ = jax_pass
    ps = interop.scene_data(scene, device="cpu")
    soup = assemble_scene_planar(ps.batches, cases.t(view), cases.t(proj))
    setup = triangle_setup_planar(soup.clip, cases.W, cases.H)
    rec = fused.build_record_table_planar(setup, soup)
    px, _, _ = fused.raster_fused(rec, setup, cases.W, cases.H, **CAPS)
    np.testing.assert_array_equal(px.tri_id.numpy(),
                                  np.asarray(pallas_out[0].tri_id))
