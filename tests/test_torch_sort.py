"""Port binning and pair sort (K3's plain version) vs the JAX package:
bin_pairs outputs bit-equal on identical setups, sort_pairs equal to
lax.sort on unique (tile, tri) pairs; K3's digit plan and its LSD passes
(emulated with tensor ops) against torch.sort and the JAX pair sorts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
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


# --- K3's digit plan and its LSD passes -----------------------------------

def _layout_keys(layout: str, seed: int = 11):
    """(keys int32/int64 numpy, (tile, tri[, zub], nt, t) or None): pair
    keys packed as ops/sort.py packs them, with the sentinel tile ``nt`` on
    the dead pairs, and keys that stress the digit plan."""
    rng = np.random.default_rng(seed)
    if layout in ("config3_i32", "sentinel_tail_i32"):
        nt, t, p = 2025, 10_002, 20_000
        tile = rng.integers(0, nt, p).astype(np.int32)
        dead = rng.random(p) < (0.3 if layout == "config3_i32" else 0.95)
        tile[dead] = nt
        tri = rng.integers(0, t, p).astype(np.int32)
        bits = sort.pack_bits(nt, t)
        return (tile << bits) | tri, (tile, tri, nt, t)
    if layout == "config4_earlyz_i64":
        nt, t, p = 2025, 640_002, 20_000
        tile = rng.integers(0, nt + 1, p).astype(np.int32)
        tri = rng.integers(0, t, p).astype(np.int32)
        zub = rng.random(p).astype(np.float32)
        inv = (1 << 16) - 1 - (zub.view(np.int32) >> 14)
        keys = ((tile.astype(np.int64) << 49)
                | ((inv.astype(np.int64) + (1 << 16)) << 32)
                | tri.astype(np.int64))
        return keys, (tile, tri, zub, nt, t)
    if layout == "all_equal_i32":
        return np.full(5000, 123_456_789, np.int32), None
    if layout == "negative_i64":
        k = rng.integers(-(1 << 62), 1 << 62, 20_000, dtype=np.int64)
        k[::7] = k[3]  # duplicates
        return k, None
    raise ValueError(layout)


_LAYOUTS = ["config3_i32", "sentinel_tail_i32", "config4_earlyz_i64",
            "all_equal_i32", "negative_i64"]


def _numpy_digits(keys: np.ndarray) -> np.ndarray:
    """(P, D) uint8: the bytes of each key's order-preserving unsigned
    form, least significant first (independent of ops/sort.py)."""
    ut = np.uint32 if keys.dtype == np.int32 else np.uint64
    u = keys.view(ut) ^ ut(1 << (8 * keys.itemsize - 1))
    return u.astype(u.dtype.newbyteorder("<")).view(np.uint8).reshape(
        -1, keys.itemsize)


def _lsd_emulation(keys: torch.Tensor, plan) -> torch.Tensor:
    """K3's passes as tensor ops: per planned digit a stable scatter to
    (keys before it with a smaller digit) + (earlier keys with its
    digit)."""
    for d in plan:
        dig = sort.radix_digits(keys)[d]
        counts = torch.bincount(dig, minlength=256)
        base = torch.cumsum(counts, 0) - counts
        onehot = torch.nn.functional.one_hot(dig, 256)
        rank = (torch.cumsum(onehot, 0, dtype=torch.int32) - onehot)[
            torch.arange(keys.numel()), dig]
        out = torch.empty_like(keys)
        out[base[dig] + rank] = keys
        keys = out
    return keys


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_digit_plan(layout):
    """digit_plan names exactly the digits on which some keys differ."""
    keys, _ = _layout_keys(layout)
    got = sort.digit_plan(torch.from_numpy(keys))
    b = _numpy_digits(keys)
    want = tuple(d for d in range(b.shape[1])
                 if (b[:, d] != b[0, d]).any())
    assert got == want
    np.testing.assert_array_equal(
        sort.radix_digits(torch.from_numpy(keys)).numpy().T, b)
    expect = {"config3_i32": (0, 1, 2, 3), "sentinel_tail_i32": (0, 1, 2, 3),
              "config4_earlyz_i64": (0, 1, 2, 4, 5, 6, 7),
              "all_equal_i32": (), "negative_i64": tuple(range(8))}
    assert got == expect[layout]


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_lsd_passes_match_sorts(layout):
    """The planned passes alone sort the keys as torch.sort does, and the
    pair layouts decode to the JAX package's sort_pairs / sort_pairs_z."""
    keys, pairs = _layout_keys(layout)
    kt = torch.from_numpy(keys)
    got = _lsd_emulation(kt, sort.digit_plan(kt))
    assert torch.equal(got, torch.sort(kt).values)
    if pairs is None:
        return
    if layout == "config4_earlyz_i64":
        tile, tri, zub, nt, t = pairs
        ref = jsort.sort_pairs_z(jnp.asarray(tile), jnp.asarray(zub),
                                 jnp.asarray(tri), nt, t, bits=0)
        dec = ((got >> 49).to(torch.int32), (got & 0xFFFFFFFF).to(
            torch.int32))
    else:
        tile, tri, nt, t = pairs
        # Unique pairs, as bin_pairs makes them: keep each key once.
        uniq = torch.unique(kt)
        bits = sort.pack_bits(nt, t)
        tile, tri = (uniq >> bits).numpy(), (uniq & ((1 << bits) - 1)).numpy()
        ref = jsort.sort_pairs(jnp.asarray(tile), jnp.asarray(tri), nt, t)
        got = _lsd_emulation(uniq, sort.digit_plan(uniq))
        dec = (got >> bits, got & ((1 << bits) - 1))
    for g, r in zip(dec, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
