"""The raster schedule variants of the port — early-z (K9), the group
window (K10), fine subtiles (K11) — its raster against the reference's
merged coverage, and the early-z pair order, against the JAX package's ``raster_fused_pallas`` in interpret mode
and against the port's own K1, on a config-4-like frame: small UV-sphere
instances over the ground plane at 256×128 (tests/torch_port_cases.py).

Tolerances: triangle ids, BinDiag counts and binning are bit-equal to the
JAX package; depth keys are held to K1's bound (XLA:CPU's FMA contraction,
ROADMAP queue 3). Between the port's own variants everything is
bit-equal on drop-free capacities."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops import sort_pallas as jsort
from bibim_tpu.ops.raster import triangle_setup as j_setup_indexed
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops import sort as psort
from bibim_tpu_torch.ops.raster import triangle_setup
from tests import torch_port_cases as cases

W, H, TH, TW, NT = cases.W, cases.H, cases.TILE_H, cases.TILE_W, cases.NT
ONE_PASS = dict(max_candidates=512, overflow_cap=64, span_cap=16)
# Windows of 128 over a frame whose densest tile has 343 candidates:
# pass-0 compaction, 3 depth-chained passes on a compacted dense grid.
MULTI = dict(max_candidates=128, passes=3, overflow_cap=64, span_cap=16,
             raster_tile_cap=NT, dense_tile_cap=16)


@pytest.fixture(scope="module")
def inst():
    cases.cap_threads()
    return cases.jax_pass_of(*cases.instanced_scene())


def _jax(inst, **kw):
    setup, rec, _, _ = inst
    return jfused.raster_fused_pallas(rec, setup, W, H, tile_h=TH,
                                      tile_w=TW, interpret=True, **kw)


def _port(inst, **kw):
    _, _, psetup, prec = inst
    return fused.raster_fused(prec, psetup, W, H, tile_h=TH, tile_w=TW,
                              **kw)


def test_scene_is_dense_enough(inst):
    """The frame exercises what the variants are for: windows beyond two
    128-candidate passes, an overflow list."""
    _, _, psetup, _ = inst
    _, _, counts, _, n_big, _, _, _ = fused.bin_pairs(
        psetup, W, H, TH, TW, 16, 64, 1 << 20)
    assert int(counts.max()) > 2 * 128 and int(n_big[0]) > 0


# MULTI without the pass-0 compaction: pass 0 on the full tile grid.
MULTI_FULL = dict(MULTI, raster_tile_cap=None)


@pytest.mark.parametrize("kw", [ONE_PASS, MULTI, MULTI_FULL],
                         ids=["one_pass", "multi", "multi_full_grid"])
def test_earlyz_matches_pallas(inst, kw):
    """K9's plain version (every pass) vs the JAX package's early-z."""
    got = _port(inst, earlyz=True, **kw)
    cases.assert_raster_close(got, _jax(inst, earlyz=True, **kw))
    assert int(got[2].dropped_cap) == 0


@pytest.mark.parametrize("kw", [ONE_PASS, MULTI, MULTI_FULL],
                         ids=["one_pass", "multi", "multi_full_grid"])
def test_earlyz_equals_k1(inst, kw):
    """On drop-free capacities the early-z frame is the draw-ordered
    frame bit for bit (no cross-split ties in this scene)."""
    base = _port(inst, **kw)
    ez = _port(inst, earlyz=True, **kw)
    assert int(base[2].dropped_cap) == 0
    cases.assert_raster_equal(ez, base)


def _two_tri(first, second):
    """JAX and port (setup, records) of two triangles given in clip space,
    drawn in that order."""
    clip = np.concatenate([first, second], axis=0)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    js = j_setup_indexed(jnp.asarray(clip), jnp.asarray(tris), W, H)
    z3 = jnp.zeros((6, 3), jnp.float32)
    jrec = jfused.build_record_table(js, jnp.asarray(tris), z3[:, :2], z3,
                                     z3, z3, z3)
    ps = triangle_setup(cases.t(clip), cases.t(tris), W, H)
    pz = torch.zeros((6, 3))
    prec = fused.build_record_table(ps, cases.t(tris), pz[:, :2], pz, pz,
                                    pz, pz)
    return js, jrec, ps, prec


_BIG = np.array([[-3.0, -3.0, 0.5, 1.0], [3.0, -3.0, 0.5, 1.0],
                 [0.0, 5.0, 0.5, 1.0]], np.float32)
_SMALL = np.array([[0.0, -0.4, 0.5, 1.0], [0.4, -0.4, 0.5, 1.0],
                   [0.1, 0.2, 0.5, 1.0]], np.float32)


@pytest.mark.parametrize("first,second,span_cap", [
    (_BIG, _BIG, 16), (_SMALL, _BIG, 2), (_BIG, _SMALL, 1),
    (_SMALL, _BIG, 1)], ids=["identical", "small_then_big",
                             "big_then_small_split", "small_then_big_split"])
def test_earlyz_constructed_ties(first, second, span_cap):
    """Bit-equal depth at every pixel both cover: the later draw wins,
    across the big/small split in both orders, as in the JAX package's
    early-z (tests/test_fused.py TestEarlyZ)."""
    js, jrec, ps, prec = _two_tri(first, second)
    kw = dict(tile_h=TH, tile_w=TW, max_candidates=64, overflow_cap=8,
              span_cap=span_cap)
    px, _, _ = fused.raster_fused(prec, ps, W, H, earlyz=True, **kw)
    px_j, _, _ = jfused.raster_fused_pallas(jrec, js, W, H, earlyz=True,
                                            interpret=True, **kw)
    tid = px.tri_id.numpy()
    np.testing.assert_array_equal(tid, np.asarray(px_j.tri_id))
    assert (tid == 1).any()
    if second is _BIG:
        assert (tid[tid >= 0] == 1).all()
    else:
        assert (tid == 0).any()


def test_group_window_matches_pallas(inst):
    """K10's plain version with a window that holds every group: the JAX
    group-window raster, and the port's K1 bit for bit."""
    kw = dict(ONE_PASS, raster_tile_cap=NT)
    got = _port(inst, group_pair_cap=2048, **kw)
    cases.assert_raster_close(got, _jax(inst, group_pair_cap=2048, **kw))
    assert int(got[2].dropped_cap) == 0
    cases.assert_raster_equal(got, _port(inst, **kw))


def test_group_window_overflow_counts_like_pallas(inst):
    """A window too small for its group keeps the same rows and reports
    the same dropped_cap as the reference."""
    kw = dict(ONE_PASS, raster_tile_cap=NT, group_pair_cap=64)
    got = _port(inst, **kw)
    assert int(got[2].dropped_cap) > 0
    cases.assert_raster_close(got, _jax(inst, **kw))


def test_group_window_gate(inst):
    """The reference's gate: no group window with more than one pass,
    without a pass-0 tile cap, or under fine_bins — and early-z stays on
    only where the group window is off."""
    calls = []

    def gw(*a, **k):
        calls.append("gw")
        return fused.raster_tiles_gw(*a, **k)

    def ez(*a, **k):
        calls.append("ez")
        return fused.raster_tiles_earlyz(*a, **k)

    for kw, want in ((dict(MULTI, group_pair_cap=2048), "ez"),
                     (dict(ONE_PASS, group_pair_cap=2048), "ez"),
                     (dict(ONE_PASS, group_pair_cap=2048,
                           raster_tile_cap=NT), "gw")):
        calls.clear()
        _port(inst, earlyz=True, raster_gw=gw, raster_earlyz=ez, **kw)
        assert set(calls) == {want}, (kw, calls)
    calls.clear()
    _port(inst, earlyz=True, fine_bins=True, group_pair_cap=2048,
          raster_gw=gw, raster_earlyz=ez, **dict(ONE_PASS,
                                                 raster_tile_cap=NT))
    assert calls == []


@pytest.mark.parametrize("kw", [ONE_PASS, MULTI], ids=["one_pass", "multi"])
def test_fine_bins_match_pallas(inst, kw):
    """K11's plain version on pass 0 (K1 on passes ≥ 1 over the
    fine-ordered windows): the JAX fine-bin raster, and the port's coarse
    raster bit for bit."""
    got = _port(inst, fine_bins=True, **kw)
    cases.assert_raster_close(got, _jax(inst, fine_bins=True, **kw))
    assert int(got[2].dropped_cap) == 0
    cases.assert_raster_equal(got, _port(inst, **ONE_PASS))


def test_fine_bins_init_zkey_and_drops(inst):
    """Fine bins continue a depth buffer (re-rastering against its own
    keys re-wins every pixel) and count window drops like the
    reference."""
    base = _port(inst, **ONE_PASS)
    again = _port(inst, fine_bins=True, init_zkey=base[1], **ONE_PASS)
    np.testing.assert_array_equal(again[1].numpy(), base[1].numpy())
    np.testing.assert_array_equal(again[0].tri_id.numpy(),
                                  base[0].tri_id.numpy())
    small = dict(ONE_PASS, max_candidates=16)
    got = _port(inst, fine_bins=True, **small)
    assert int(got[2].dropped_cap) > 0
    cases.assert_raster_close(got, _jax(inst, fine_bins=True, **small))


def test_merged_coverage_on_off_and_pallas(inst):
    """The port's raster (merged coverage has no counterpart on the GPU)
    matches the JAX package's raster with its merged-coverage schedule on
    and off."""
    got = _port(inst, **MULTI)
    cases.assert_raster_close(got, _jax(inst, merged_coverage=True, **MULTI))
    cases.assert_raster_close(got, _jax(inst, **MULTI))


@pytest.mark.parametrize("nt,t", [(32, 5000), (4080, 640_002), (1, 1),
                                  (8100, 20_000)])
def test_zorder_bits(nt, t):
    assert psort.zorder_bits(nt, t) == jsort.zorder_bits(nt, t)


@pytest.mark.parametrize("nt,t", [(32, 3000), (4080, 640_002)],
                         ids=["int32_key", "int64_key"])
def test_sort_pairs_z_matches_jax(nt, t):
    """(tile, descending depth bucket, tri): the packed int32 key when
    ``zorder_bits`` > 0, the 3-operand order as one int64 key at 0."""
    rng = np.random.default_rng(3)
    p = 3000
    tile = rng.integers(0, nt + 1, p).astype(np.int32)
    tri = rng.permutation(t)[:p].astype(np.int32)
    zub = rng.random(p).astype(np.float32)
    zub[:50] = 0.0
    zub[50:60] = 1.0
    bits = psort.zorder_bits(nt, t)
    assert (bits > 0) == (nt == 32)
    st, sr = psort.sort_pairs_z(cases.t(tile), cases.t(zub), cases.t(tri),
                                nt, t, bits)
    jt, jr = jsort.sort_pairs_z(jnp.asarray(tile), jnp.asarray(zub),
                                jnp.asarray(tri), nt, t, bits)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(sr.numpy(), np.asarray(jr))
    assert st.dtype == torch.int32 and sr.dtype == torch.int32


@pytest.mark.parametrize("span_mid_cap", [None, 256], ids=["dense", "mid"])
def test_bin_pairs_zorder_matches_jax(inst, span_mid_cap):
    setup, _, psetup, _ = inst
    args = (W, H, TH, TW, 16, 64, 512)
    got = fused.bin_pairs(psetup, *args, span_mid_cap=span_mid_cap,
                          zorder=True)
    want = jfused.bin_pairs(setup, *args, span_mid_cap=span_mid_cap,
                            zorder=True)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a.numpy().reshape(-1),
                                      np.asarray(b).reshape(-1))
    plain = fused.bin_pairs(psetup, *args, span_mid_cap=span_mid_cap)
    assert not torch.equal(got[0], plain[0])
    np.testing.assert_array_equal(got[2].numpy(), plain[2].numpy())
