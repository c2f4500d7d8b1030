"""Port binning and pair sort (K3's plain version) vs the JAX package:
bin_pairs outputs bit-equal on identical setups, sort_pairs equal to
lax.sort on unique (tile, tri) pairs."""

import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops import sort_pallas as jsort
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.ops.raster import triangle_setup_planar as j_setup_planar
from bibim_tpu_torch.ops import fused, sort
from tests import torch_port_cases as cases


@pytest.fixture(scope="module")
def jsetup():
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    soup = j_assemble(scene.batches, view, proj)
    return j_setup_planar(soup.clip, cases.W, cases.H)


@pytest.mark.parametrize("p,nt", [(4096, 2026), (30000, 511), (900, 64)])
def test_sort_pairs_matches_lax_sort(p, nt):
    """test_fused.py's sort cases: unique pairs, any sentinel tile."""
    rng = np.random.default_rng(7)
    tile = rng.integers(0, nt + 1, p).astype(np.int32)
    tri = rng.permutation(p).astype(np.int32)
    ref = lax.sort((jnp.asarray(tile), jnp.asarray(tri)), num_keys=2,
                   is_stable=False)
    got = sort.sort_pairs(cases.t(tile), cases.t(tri), nt, t_count=p)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sort_pairs_int64_keys():
    """Keys that do not fit int32 sort as int64, same order."""
    rng = np.random.default_rng(3)
    nt, t = 1 << 14, 1 << 20
    assert sort.pack_bits(nt, t) is None
    tile = rng.integers(0, nt + 1, 5000).astype(np.int32)
    tri = rng.choice(t, 5000, replace=False).astype(np.int32)
    ref = lax.sort((jnp.asarray(tile), jnp.asarray(tri)), num_keys=2,
                   is_stable=False)
    got = sort.sort_pairs(cases.t(tile), cases.t(tri), nt, t_count=t)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pack_bits_matches():
    for nt, t in [(2025, 1 << 19), (1 << 14, 1 << 20), (32, 1), (2025, 600)]:
        assert sort.pack_bits(nt, t) == jsort.pack_bits(nt, t)


@pytest.mark.parametrize("kw", [
    dict(span_cap=16, overflow_cap=64, max_candidates=320),
    dict(span_cap=16, overflow_cap=64, max_candidates=48,
         span_mid_cap=256),
    dict(span_cap=4, overflow_cap=8, max_candidates=8, span_mid_cap=16,
         pair_budget=200),
], ids=["single_class", "span_class", "tight_caps"])
def test_bin_pairs_bit_equal(jsetup, kw):
    """sorted_tri, starts, counts, big_ids, n_big and every diag count
    equal the JAX package's on the same setup — drops included."""
    want = jfused.bin_pairs(jsetup, cases.W, cases.H, cases.TILE_H,
                            cases.TILE_W, **kw)
    got = fused.bin_pairs(cases.planar_setup(jsetup), cases.W, cases.H,
                          cases.TILE_H, cases.TILE_W, **kw)
    for name, g, w in zip(("sorted_tri", "starts", "counts", "big_ids",
                           "n_big"), got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy().reshape(-1),
                                      np.asarray(w).reshape(-1), err_msg=name)
    for g, w in zip(got[5], want[5]):
        assert int(g) == int(w)
    assert got[6:] == want[6:]
    if "pair_budget" in kw:  # the tight case drops candidates and pairs
        assert int(got[5].dropped_cap) > 0 and int(got[5].dropped_pairs) > 0
