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


def _doubled(jax_pass):
    """The pass's triangles twice over, each copy after every original in
    draw order (ids T..2T-1, records renumbered): a copy ties its
    original's key at every pixel, so every winner is a copy."""
    *_, setup, rec = jax_pass
    r = np.asarray(rec)
    copy = r.copy()
    live = copy[:, fused._ID] > 0
    copy[live, fused._ID] += r.shape[0]

    def cat(x):
        return jnp.concatenate([x, x])

    planes = {f: tuple(cat(c) for c in getattr(setup, f))
              for f in ("edge_a", "edge_b", "edge_c", "z_coef", "w_coef",
                        "bbox")}
    return (setup._replace(valid=cat(setup.valid),
                           zub=None if setup.zub is None else cat(setup.zub),
                           **planes),
            jnp.asarray(np.concatenate([r, copy])))


@pytest.fixture(scope="module")
def jax_multipass(jax_pass):
    """The JAX package's multi-pass raster (Pallas kernel, interpret
    mode), once per scene and settings."""
    memo = {}

    def run(doubled: bool, **kw):
        key = (doubled, tuple(sorted(kw.items())))
        if key not in memo:
            setup, rec = (_doubled(jax_pass) if doubled
                          else jax_pass[-2:])
            memo[key] = jfused.raster_fused_pallas(
                rec, setup, cases.W, cases.H, tile_h=cases.TILE_H,
                tile_w=cases.TILE_W, interpret=True, **dict(CAPS, **kw))
        return memo[key]

    return run


# (doubled scene, settings). The test scene's tiles hold 2-34 candidates
# (the doubled scene's 4-68), so small windows give every case a tail.
TAIL_CASES = {
    "passes2": (False, dict(max_candidates=24, passes=2)),
    "passes4": (False, dict(max_candidates=16, passes=4)),
    "passes4_tile_cap": (False, dict(max_candidates=16, passes=4,
                                     raster_tile_cap=cases.NT,
                                     dense_tile_cap=24)),
    "fine_bins": (False, dict(max_candidates=16, passes=4,
                              fine_bins=True)),
    "band": (False, dict(max_candidates=16, passes=4)),
    # A tile of 40 candidates ends on the edge of window 2.
    "window_edge": (True, dict(max_candidates=20, passes=4)),
    # A tile of n ≤ 32 originals < 2n candidates: each original in window
    # 0, its equal-key copy n rows on, past maxc for the later ones.
    "duplicates_at_edge": (True, dict(max_candidates=32, passes=3)),
    # 22, 21, 9 and 1 tiles past windows 1-4 for 4 slots: 18 + 17 + 5.
    "dense_cap_overflow": (False, dict(max_candidates=8, passes=5,
                                       dense_tile_cap=4)),
}
def _leaves(px):
    return [c for f in px for c in (f if isinstance(f, tuple) else (f,))]


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_matches_chained_passes(jax_pass, jax_multipass, case):
    """raster_fused's passes 1..P-1 as K1's tail (its plain version on the
    CPU) against the JAX package's chained multi-pass raster: the same
    triangle on every pixel and the same BinDiag, and every plane and key
    bit-equal to the port's single pass (what drop-free chained passes
    give); with a dense_tile_cap overflow, JAX's per-pass dropped_tiles
    sum."""
    doubled, kw = TAIL_CASES[case]
    setup_j, rec_j = _doubled(jax_pass) if doubled else jax_pass[-2:]
    rec, setup = cases.record_table(rec_j), cases.planar_setup(setup_j)
    args = dict(CAPS, tile_h=cases.TILE_H, tile_w=cases.TILE_W)
    multi = dict(args, **kw)
    counts = fused.bin_pairs(setup, cases.W, cases.H, cases.TILE_H,
                             cases.TILE_W, CAPS["span_cap"],
                             CAPS["overflow_cap"], 1 << 20)[2]
    maxc = kw["max_candidates"]
    assert bool((counts > maxc).any())  # the tail has work
    got = fused.raster_fused(rec, setup, cases.W, cases.H, **multi)
    want = jax_multipass(doubled, **kw)
    assert [int(d) for d in got[2]] == [int(d) for d in want[2]]
    if case == "dense_cap_overflow":
        assert int(got[2].dropped_tiles) == 40
        return
    single = fused.raster_fused(rec, setup, cases.W, cases.H, **args)
    tri_j = np.asarray(want[0].tri_id)
    if case == "band":
        y0, band_h = 32, 64
        clip = tuple(tuple(cases.t(c) for c in k) for k in jax_pass[3].clip)
        band = triangle_setup_planar(clip, cases.W, cases.H, band_y0=y0,
                                     band_height=band_h)
        got = fused.raster_fused(rec, band, cases.W, band_h, band_y0=y0,
                                 **multi)
        rows = slice(y0 // cases.TILE_H * cases.TX,
                     (y0 + band_h) // cases.TILE_H * cases.TX)
        single = (_pixels_rows(single[0], rows), single[1][rows],
                  single[2])
        tri_j = tri_j[rows]
    for d in list(got[2]) + list(want[2]):
        assert int(d) == 0
    np.testing.assert_array_equal(got[0].tri_id.numpy(), tri_j)
    np.testing.assert_array_equal(got[1].numpy(), single[1].numpy())
    for a, b in zip(_leaves(got[0]), _leaves(single[0])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    hit = got[0].tri_id >= 0
    assert float(hit.float().mean()) > 0.3
    if case == "window_edge":
        assert bool(((counts % maxc == 0) & (counts > maxc)).any())
    if case == "duplicates_at_edge":
        assert bool(((counts > maxc) & (counts < 2 * maxc)).any())
        assert bool((got[0].tri_id[hit] >= rec.shape[0] // 2).all())


def _tail_slot(ends: list, g: int) -> int:
    """csrc/raster.cu ``tail_slot``: the first s with ends[s] > g, the
    range narrowed 32 segments a round as a warp's ballot narrows it."""
    lo, hi = 0, len(ends)
    while hi - lo > 1:
        step = -(-(hi - lo) // 32)
        lane = next(j for j in range(32)
                    if ends[min(lo + (j + 1) * step, hi) - 1] > g)
        lo += lane * step
        hi = min(hi, lo + step)
    return lo


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 1000, 2048])
def test_tail_slot_finds_every_parts_slot(n):
    """Each part of K1's tail's flat list finds its slot, slots without
    parts (dead slots, short tails) in every position among them."""
    gen = torch.Generator().manual_seed(n)
    parts = torch.randint(0, 4, (n,), generator=gen)
    parts[n // 2] = 2  # some part lies in the list
    ends = torch.cumsum(parts, 0)
    total = int(ends[-1])
    want = torch.searchsorted(ends, torch.arange(total), right=True)
    assert [_tail_slot(ends.tolist(), g) for g in range(total)] == \
        want.tolist()


NONE = torch.iinfo(torch.int64).min  # no part posted: the key stands


def _packed_best(key, pos):
    """``pack_best``: (key, position) as one int64 ordered as the pair
    (the kernel's unsigned word, here signed)."""
    return (key.to(torch.int64) << 32) | (pos + 1)


def tail_parts_replay(rec, pair_tri, ids, starts, counts, zkey, fields,
                      tiles_x, tile_h, tile_w, out_fields=fused._OUT_FIELDS,
                      row0=0, part=fused.CLUSTER_MIN_PART):
    """K1's tail as its kernel deals the work, in tensor ops: the slots'
    sequences in parts of ``part`` on one flat list (the prefix sums of
    their part counts), taken in a shuffled order (the kernel's blocks
    take them from a counter and finish in any order), each part scanned
    from its slot's initial keys; a part posts the packed (key, position)
    of the pixels where one of its candidates won, the slot keeps the max
    of what its parts posted, and only those pixels take the winner's key
    and, where it is a triangle, its planes."""
    k, npx = ids.shape[0], tile_h * tile_w
    ends = torch.cumsum((counts + part - 1) // part, 0).tolist()
    rows = (ids - row0 * tiles_x).long()
    best = torch.full((k, npx), NONE, dtype=torch.int64)
    empty = torch.zeros((0,), dtype=torch.int32)
    order = torch.randperm(ends[-1] if k else 0,
                           generator=torch.Generator().manual_seed(part))
    for g in order.tolist():
        s = _tail_slot(ends, g)
        lo = (g - (ends[s - 1] if s else 0)) * part
        n = min(int(counts[s]) - lo, part)
        px, py = fused._pixel_centres(ids[s:s + 1], tiles_x, tile_h, tile_w)
        bkey = zkey[rows[s]][None] & fused.LOW3
        bpos = torch.full((1, npx), -1, dtype=torch.int64)
        c0 = lo
        for tri, _, ok, z in fused._plain_chunks(
                rec, empty, torch.zeros((1,), dtype=torch.int32), pair_tri,
                starts[s:s + 1] + lo, torch.tensor([n], dtype=torch.int32),
                px, py):
            key = z.view(torch.int32) & fused.LOW3
            for r in range(tri.shape[1]):  # in order, ties to the later
                take = ok[:, r] & (tri[:, r:r + 1] >= 0) & (key[:, r]
                                                            >= bkey)
                bkey = torch.where(take, key[:, r], bkey)
                bpos = torch.where(take, torch.full_like(bpos, c0 + r),
                                   bpos)
            c0 += tri.shape[1]
        post = torch.where(bpos >= 0, _packed_best(bkey, bpos),
                           torch.full_like(bpos, NONE))
        best[s] = torch.maximum(best[s], post[0])
    won = best != NONE
    key = (best >> 32).to(torch.int32)
    pos = (best & 0xFFFFFFFF) - 1
    tri = torch.where(won, pair_tri[(starts[:, None] + pos.clamp(min=0))
                                    .clamp(max=pair_tri.shape[0] - 1)
                                    .long()], torch.full_like(key, -1))
    px, py = fused._pixel_centres(ids, tiles_x, tile_h, tile_w)
    f = fused._resolve_plain(rec, tri, px, py, out_fields)
    hit = won & (f[out_fields.index("idf")] >= 0.5)
    for s in range(k):
        if int(counts[s]) == 0:
            continue
        zkey[rows[s]] = torch.where(won[s], key[s], zkey[rows[s]])
        fields[:, rows[s]] = torch.where(hit[s], f[:, s], fields[:, rows[s]])
    return zkey, fields


@pytest.mark.parametrize("part", [3, 8, 64])
def test_tail_parts_merge_to_the_chained_scan(jax_pass, part):
    """K1's tail as its kernel deals and merges its parts
    (:func:`tail_parts_replay`) equals raster_tiles_tail_plain bit for
    bit, on the doubled scene (every winner ties its original's key) with
    windows of 8: tails of up to 60 candidates in 1-20 parts a slot, the
    list holding dead slots."""
    setup_j, rec_j = _doubled(jax_pass)
    rec, setup = cases.record_table(rec_j), cases.planar_setup(setup_j)
    calls = []

    def capture(*a, **k):
        calls.append(a[:5] + (a[5].clone(), a[6].clone()) + a[7:])
        return fused.raster_tiles_tail_plain(*a, **k)

    fused.raster_fused(rec, setup, cases.W, cases.H, tile_h=cases.TILE_H,
                       tile_w=cases.TILE_W, **dict(CAPS, max_candidates=8,
                                                   passes=9),
                       raster_tail=capture)
    (a,) = calls
    counts = a[4]
    assert bool((counts == 0).any()) and int(counts.max()) > 2 * part \
        or part == 64
    want = fused.raster_tiles_tail_plain(
        *(a[:5] + (a[5].clone(), a[6].clone()) + a[7:]))
    got = tail_parts_replay(*(a[:5] + (a[5].clone(), a[6].clone()) + a[7:]),
                            part=part)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert not torch.equal(want[0], a[5])  # the tail won pixels


def _pixels_rows(px, rows):
    return type(px)(*(tuple(c[rows] for c in f) if isinstance(f, tuple)
                      else f[rows] for f in px))


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
