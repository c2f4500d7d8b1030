"""The port's standalone samplers — K6 (block table) and K7 (small quad
table) plain versions — and the ``sample_material`` dispatch vs the JAX
package's Pallas kernels in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.pipeline import KERNELS, PLAIN
from tests import torch_port_cases as cases

TILE_H, TILE_W = 8, 128
NT = 6


def _uv(seed, nt=NT, lo=-2.0, hi=3.0):
    rng = np.random.default_rng(seed)
    shape = (nt, TILE_H * TILE_W)
    return (rng.uniform(lo, hi, shape).astype(np.float32),
            rng.uniform(lo, hi, shape).astype(np.float32))


@pytest.fixture(scope="module")
def tables():
    """64² metallic/roughness/ao as a block table, 16² albedo/normal/height
    as a small quad table, and a 48² quad table above SMALL_ROWS."""
    cases.cap_threads()
    maps = cases.material_maps(3)
    maps["ao"] = np.random.default_rng(4).integers(0, 256, (48, 48, 1),
                                                   dtype=np.uint8)
    jt = jtq.build_quad_tables(maps, block_threshold=3000)
    return jt, interop.material_tables(jt, device="cpu")


def _by_kind(tabs, kind, rows=None):
    return next(t for t in tabs if type(t).__name__ == kind
                and (rows is None or t.height * t.width == rows))


def test_tables_cover_each_route(tables):
    jt, pt = tables
    kinds = sorted((type(t).__name__, t.height * t.width) for t in pt)
    assert kinds == [("BlockTable", 4096), ("QuadTable", 256),
                     ("QuadTable", 2304)]
    assert 2304 > tq.SMALL_ROWS == jtq.SMALL_ROWS >= 256


@pytest.mark.parametrize("seed", [0, 1])
def test_block_plain_matches_block_blend_kernel(tables, seed):
    """K6's plain version vs ``sample_table_block_pallas`` (interpret):
    the reference test's 3e-7 bound (XLA:CPU fuses the blend's FMAs)."""
    jt, pt = tables
    u, v = _uv(seed)
    want = jtq.sample_table_block_pallas(_by_kind(jt, "BlockTable"),
                                         jnp.asarray(u), jnp.asarray(v),
                                         interpret=True)
    got = tq.sample_table_block_kernel(_by_kind(pt, "BlockTable"),
                                       cases.t(u), cases.t(v))
    assert set(got) == set(want)
    for s in got:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=3e-7, atol=3e-7, err_msg=s)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_plain_matches_small_kernel(tables, seed):
    """K7's plain version (the ``_blend`` order) vs
    ``sample_table_small_pallas`` (interpret): the one-hot select is exact,
    so only the blend's FMA contraction separates them."""
    jt, pt = tables
    u, v = _uv(seed + 10)
    jq, pq = _by_kind(jt, "QuadTable", 256), _by_kind(pt, "QuadTable", 256)
    want = jtq.sample_table_small_pallas(jq, jnp.asarray(u), jnp.asarray(v),
                                         TILE_H, TILE_W, interpret=True)
    got = tq.sample_table_small(pq, cases.t(u), cases.t(v))
    assert set(got) == set(want) == set(pq.present)
    for s in got:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=3e-7, atol=3e-7, err_msg=s)


def test_small_rows_out_of_range_sample_zero(tables):
    """A row index outside the table selects no row in the one-hot
    product: the reference samples 0 there, and so does K7."""
    jt, pt = tables
    jq, pq = _by_kind(jt, "QuadTable", 256), _by_kind(pt, "QuadTable", 256)
    rng = np.random.default_rng(5)
    shape = (2, TILE_H * TILE_W)
    idx = rng.integers(-40, 300, shape).astype(np.int32)
    tx = rng.uniform(0, 1, shape).astype(np.float32)
    ty = rng.uniform(0, 1, shape).astype(np.float32)
    want = jtq.sample_rows_small_pallas(jq.quads, jnp.asarray(idx),
                                        jnp.asarray(tx), jnp.asarray(ty),
                                        TILE_H, TILE_W, jq.present,
                                        interpret=True)
    got = tq.sample_rows_small(pq.quads, cases.t(idx), cases.t(tx),
                               cases.t(ty), pq.present)
    out = (idx < 0) | (idx >= 256)
    assert out.any() and not out.all()
    for s in got:
        g = got[s].numpy()
        assert (g[out] == 0).all()
        np.testing.assert_allclose(g, np.asarray(want[s]), rtol=3e-7,
                                   atol=3e-7, err_msg=s)


@pytest.mark.parametrize("kernels", [KERNELS, PLAIN],
                         ids=["kernels", "plain"])
def test_sample_material_dispatch_matches_pallas_route(tables, kernels):
    """Block table → K6, ≤ SMALL_ROWS quad table → K7, the 48² table →
    the XLA sampler; against ``sample_material(use_pallas=True)`` in
    interpret mode."""
    jt, pt = tables
    u, v = _uv(7)
    want = jtq.sample_material(jt, jnp.asarray(u), jnp.asarray(v), TILE_H,
                               TILE_W, use_pallas=True, interpret=True)
    got = tq.sample_material(pt, cases.t(u), cases.t(v), kernels)
    assert set(got) == set(want) == set(tq.SLOTS)
    for s in got:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=3e-7, atol=3e-7, err_msg=s)


def test_sample_material_routes(tables, monkeypatch):
    """Each table reaches the sampler the reference's dispatch names."""
    _, pt = tables
    seen = []

    class Spy:
        def sample_block(self, t, u, v):
            seen.append(("block", t.height * t.width))
            return tq.sample_table_block(t, u, v)

        def sample_small(self, quads, idx, tx, ty, present):
            seen.append(("small", quads.shape[0]))
            return tq.sample_rows_small_plain(quads, idx, tx, ty, present)

    u, v = _uv(8, nt=1)
    real_xla = tq.sample_table_xla

    def xla(t, uu, vv):
        seen.append(("xla", t.height * t.width))
        return real_xla(t, uu, vv)

    monkeypatch.setattr(tq, "sample_table_xla", xla)
    tq.sample_material(pt, cases.t(u), cases.t(v), Spy())
    assert sorted(seen) == [("block", 4096), ("small", 256), ("xla", 2304)]
    seen.clear()
    tq.sample_material(pt, cases.t(u), cases.t(v))
    assert sorted(seen) == [("xla", 256), ("xla", 2304)]


def test_sampler_wrappers_validate_inputs(tables):
    _, pt = tables
    block = _by_kind(pt, "BlockTable")
    quad = _by_kind(pt, "QuadTable", 256)
    u = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        tq.sample_table_block_kernel(block, u, u.double())
    with pytest.raises(ValueError):
        tq.sample_table_block_kernel(block._replace(height=63), u, u)
    with pytest.raises(ValueError):
        tq.sample_rows_small(quad.quads, u, u, u, quad.present)  # float idx
    with pytest.raises(ValueError):
        tq.sample_rows_small(quad.quads[:, :16].contiguous(),
                             torch.zeros((2, 16), dtype=torch.int32), u, u,
                             quad.present)
