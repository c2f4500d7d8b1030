"""K1's candidate scan split across the blocks of a cluster, as tensor
ops: each of ``c`` contiguous parts of a slot's candidate sequence keeps
the lexicographic max of (masked depth key, candidate index), the initial
key carrying index -1, and the parts merge by the same max. That must give
the sequential ``>=`` scan of ``raster_tiles_plain`` bit for bit — on the
test frame, with every triangle duplicated (ties between different
triangles), continuing keys that every winner ties, and parts left empty —
and the JAX package's Pallas raster (interpret mode) on the test frame."""

import numpy as np
import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.ops.raster import triangle_setup_planar as j_setup_planar
from bibim_tpu_torch.ops import fused
from tests import torch_port_cases as cases

CAPS = dict(max_candidates=2048, overflow_cap=512, span_cap=8)
PARTS = [1, 2, 3, 8]


def _packed(key: torch.Tensor, idx) -> torch.Tensor:
    """(key, idx) as one int64 whose order is their lexicographic order
    (idx >= -1)."""
    return (key.to(torch.int64) << 32) | (idx + 1)


def split_scan(rec, big_ids, n_big, pair_tri, starts, counts, init_key,
               px, py, c: int, min_part: int = 1):
    """Per slot and pixel the (key, tri) of the split scan over ``c``
    parts (the kernel's part bounds: max(ceil(total / c), min_part)
    candidates each, so a short sequence leaves the last parts empty)."""
    nb = min(int(n_big.reshape(-1)[0]), big_ids.shape[0])
    total = nb + counts.to(torch.int64)
    part = torch.clamp((total + c - 1) // c, min=min_part)
    los = [torch.minimum(total, r * part) for r in range(c)]
    his = [torch.minimum(total, lo + part) for lo in los]
    init = _packed(init_key & fused.LOW3, -1)
    best = [init.clone() for _ in range(c)]  # every part starts at init
    tris = []
    c0 = 0
    for tri, _, _, z in fused._plain_chunks(rec, big_ids, n_big, pair_tri,
                                            starts, counts, px, py):
        key = z.view(torch.int32) & fused.LOW3  # (K, CHUNK, NPX)
        idx = c0 + torch.arange(tri.shape[1])
        packed = _packed(key, idx[None, :, None])
        for r in range(c):
            inside = (idx[None, :] >= los[r][:, None]) & (
                idx[None, :] < his[r][:, None])
            masked = torch.where(inside[..., None], packed,
                                 torch.iinfo(torch.int64).min)
            best[r] = torch.maximum(best[r], masked.max(dim=1).values)
        tris.append(tri)
        c0 += tri.shape[1]
    merged = torch.stack(best).max(dim=0).values
    key = (merged >> 32).to(torch.int32)
    idx = (merged & 0xFFFFFFFF) - 1
    if not tris:
        return key, torch.full_like(key, -1)
    tri_all = torch.cat(tris, dim=1)
    won = torch.gather(tri_all, 1, idx.clamp(min=0))
    return key, torch.where(idx >= 0, won, torch.full_like(won, -1))


def split_raster(c: int, min_part: int = 1):
    """raster_tiles_plain with the split scan."""
    def raster(rec, big_ids, n_big, pair_tri, ids, starts, counts,
               init_zkey, tiles_x, tile_h, tile_w,
               out_fields=fused._OUT_FIELDS, max_count=None):
        px, py = fused._pixel_centres(ids, tiles_x, tile_h, tile_w)
        key, tri = split_scan(rec, big_ids, n_big, pair_tri, starts, counts,
                              init_zkey, px, py, c, min_part)
        return key, fused._resolve_plain(rec, tri, px, py, out_fields)
    return raster


@pytest.fixture(scope="module")
def jax_pass():
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    soup = j_assemble(scene.batches, view, proj)
    setup = j_setup_planar(soup.clip, cases.W, cases.H)
    return setup, jfused.build_record_table_planar(setup, soup)


@pytest.fixture(scope="module")
def slots(jax_pass):
    """One raster call's inputs on the test frame: every tile, its window
    in sorted order and the overflow list."""
    setup, jrec = jax_pass
    rec = cases.record_table(jrec)
    sorted_tri, starts, counts, big_ids, n_big, diag, tiles_y, tiles_x = \
        fused.bin_pairs(cases.planar_setup(setup), cases.W, cases.H,
                        cases.TILE_H, cases.TILE_W, **CAPS)
    assert int(diag.dropped_cap) == 0 and int(n_big[0]) > 0
    nt = tiles_y * tiles_x
    ids = torch.arange(nt, dtype=torch.int32)
    init = torch.zeros((nt, cases.TILE_H * cases.TILE_W), dtype=torch.int32)
    return rec, big_ids, n_big, sorted_tri, ids, starts, counts, init, \
        tiles_x


def _case(slots, kind: str):
    rec, big_ids, n_big, pair_tri, ids, starts, counts, init, tx = slots
    if kind == "duplicated":
        # Every triangle twice: the copy (id + T) follows its original in
        # the overflow list and in every window, so each win is a tie that
        # the later copy must take.
        t = rec.shape[0]
        rec = torch.cat([rec, rec])
        nb = int(n_big[0])
        big = big_ids[:nb]
        big_ids = torch.stack([big, big + t], 1).reshape(-1)
        n_big = torch.tensor([2 * nb], dtype=torch.int32)
        pair_tri = torch.stack([pair_tri, pair_tri + t], 1).reshape(-1)
        starts, counts = 2 * starts, 2 * counts
    elif kind == "init_ties":
        # Continue the keys the scan itself produced: every covered pixel's
        # winner ties the initial key and must still replace it.
        init, _ = fused.raster_tiles_plain(
            rec, big_ids, n_big, pair_tri, ids, starts, counts, init, tx,
            cases.TILE_H, cases.TILE_W, ("idf",))
    return rec, big_ids, n_big, pair_tri, ids, starts, counts, init, tx


@pytest.mark.parametrize("min_part", [1, 8])
@pytest.mark.parametrize("c", PARTS)
@pytest.mark.parametrize("kind", ["frame", "duplicated", "init_ties"])
def test_split_scan_equals_sequential(slots, kind, c, min_part):
    """min_part 8 scales the kernel's 64-candidate parts to the test
    frame's windows (2-68 candidates)."""
    rec, big_ids, n_big, pair_tri, ids, starts, counts, init, tx = \
        _case(slots, kind)
    px, py = fused._pixel_centres(ids, tx, cases.TILE_H, cases.TILE_W)
    want_key, want_tri = fused._scan_plain(rec, big_ids, n_big, pair_tri,
                                           starts, counts, init, px, py)
    key, tri = split_scan(rec, big_ids, n_big, pair_tri, starts, counts,
                          init, px, py, c, min_part)
    assert torch.equal(key, want_key)
    assert torch.equal(tri, want_tri)
    zk, f = fused.raster_tiles_plain(rec, big_ids, n_big, pair_tri, ids,
                                     starts, counts, init, tx, cases.TILE_H,
                                     cases.TILE_W)
    zk_s, f_s = split_raster(c, min_part)(
        rec, big_ids, n_big, pair_tri, ids, starts, counts, init, tx,
        cases.TILE_H, cases.TILE_W)
    assert torch.equal(zk_s, zk) and torch.equal(f_s, f)
    hit = want_tri >= 0
    assert float(hit.float().mean()) > 0.3
    if kind == "duplicated":
        # Every winner is a copy (the later of two equal candidates).
        assert bool((want_tri[hit] >= rec.shape[0] // 2).all())
    if kind == "init_ties":
        assert torch.equal(key[hit], init[hit] & fused.LOW3)
    total = int(n_big[0]) + counts
    part = torch.clamp((total + c - 1) // c, min=min_part)
    parts = (total + part - 1) // part
    if c == 8:  # some slots leave parts empty, others split 2+ ways
        assert bool((parts < c).any()) and bool((parts > 1).any())
    if min_part > 1:  # some slots are one part: no merge at all
        assert bool((parts == 1).any())


@pytest.fixture(scope="module")
def pallas_tri(jax_pass):
    setup, jrec = jax_pass
    px, _, _ = jfused.raster_fused_pallas(
        jrec, setup, cases.W, cases.H, tile_h=cases.TILE_H,
        tile_w=cases.TILE_W, interpret=True, **CAPS)
    return np.asarray(px.tri_id)


@pytest.mark.parametrize("c", PARTS)
def test_split_raster_matches_pallas_interpret(jax_pass, pallas_tri, c):
    """raster_fused over the split scan (multi-pass and compacted too)
    gives the Pallas kernel's triangle ids on every pixel."""
    setup, jrec = jax_pass
    for kw in (CAPS, dict(CAPS, max_candidates=96, passes=4,
                          raster_tile_cap=cases.NT, dense_tile_cap=16)):
        px, _, diag = fused.raster_fused(
            cases.record_table(jrec), cases.planar_setup(setup), cases.W,
            cases.H, tile_h=cases.TILE_H, tile_w=cases.TILE_W, raster=split_raster(c),
            **kw)
        assert all(int(d) == 0 for d in diag)
        np.testing.assert_array_equal(px.tri_id.numpy(), pallas_tri)

