"""The early-z raster K9 and the fine-subtile raster K11 as their CUDA
kernels split the work, replayed as tensor ops and held bit for bit
against the plain versions (``raster_tiles_earlyz_plain``,
``raster_tiles_fine_plain``) and against the JAX package's Pallas rasters
in interpret mode, on the test frames.

K9 (csrc/raster_earlyz.cu): each of ``c`` contiguous parts of a slot's
candidate sequence (the kernel's part bounds) scans in rounds, keeping per
pixel the running (key, ord, position) by ``key > best || (key == best &&
ord >= best_ord)``; rank 0 starts from the initial (key, ord), the other
parts from below every candidate, so the initial value enters once. After
each round but the last a part stops when ((bmin + 2) << zsh) <= the
minimum over the tile of max(initial key, its own running key). Rank 0
folds the parts in rank order with the same rule.

K11 (csrc/raster_fine.cu): per subtile the winner is the maximum of the
packed (key, position) over the initial key (position -1) and the
candidates that survive the corner test: a candidate whose edge function
is negative at the subtile's four corner pixel centres is skipped, but only
where every initial key of the subtile is above the miss key. Rounds of a
subtile's window are dealt to warps by ``seek_round``; the maximum does
not depend on which warp merges what, so the replay checks the dealing
covers every round once.

Tolerance: bit-equal (``torch.equal``) against the plain versions; the
JAX comparison holds triangle ids equal and depth keys within K1's bound
(tests/torch_port_cases.py assert_raster_close)."""

import numpy as np
import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu_torch.ops import fused
from tests import torch_port_cases as cases
from tests.test_torch_kernels_cuda import _occluded_layers
from tests.test_torch_kernels_cuda import H as OCC_H
from tests.test_torch_kernels_cuda import W as OCC_W
from tests.test_torch_raster_split import _packed

W, H, TH, TW = cases.W, cases.H, cases.TILE_H, cases.TILE_W
INT_MIN = -(1 << 31)
MISS = int(np.float32(-1.0).view(np.int32)) & fused.LOW3
SENTINEL = 1 << 20
ONE_PASS = dict(max_candidates=512, overflow_cap=64, span_cap=16)
MULTI = dict(max_candidates=128, passes=3, overflow_cap=64, span_cap=16,
             raster_tile_cap=cases.NT, dense_tile_cap=16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _parts(total: torch.Tensor, c: int, min_part: int):
    """common.cuh cluster_part: per slot (lo, hi) of each rank and the
    parts in use."""
    part = torch.clamp((total + c - 1) // c, min=min_part)
    los = [torch.minimum(total, r * part) for r in range(c)]
    his = [torch.minimum(total, lo + part) for lo in los]
    return los, his, (total + part - 1) // part


def earlyz_split_scan(rec, big_ids, n_big, pair_tri, starts, counts,
                      init_key, init_ord, zsh: int, px, py, c: int,
                      min_part: int, round_len: int):
    """K9's split scan, position by position. Returns (key, ord, tri,
    window rows scanned) per slot and pixel (rows per slot)."""
    k_slots, npx = init_key.shape
    nb = min(int(n_big.reshape(-1)[0]), big_ids.shape[0])
    total = nb + counts.to(torch.int64)
    los, his, used = _parts(total, c, min_part)
    ikey = init_key & fused.LOW3
    key = [ikey.clone()] + [torch.full_like(ikey, INT_MIN)
                            for _ in range(c - 1)]
    ordv = [init_ord.clone()] + [torch.full_like(init_ord, -1.0)
                                 for _ in range(c - 1)]
    idx = [torch.full((k_slots, npx), -1, dtype=torch.int64)
           for _ in range(c)]
    alive = [torch.ones(k_slots, dtype=torch.bool) for _ in range(c)]
    bmin = [torch.full((k_slots,), SENTINEL, dtype=torch.int64)
            for _ in range(c)]
    rows = torch.zeros(k_slots, dtype=torch.int64)
    tris = []
    pos = 0
    for tri, co, ok, z in fused._plain_chunks(rec, big_ids, n_big, pair_tri,
                                              starts, counts, px, py):
        kz = _bits(z) & fused.LOW3
        ordc = torch.where(ok, co[..., fused._ID, None],
                           torch.tensor(-1.0))
        zub = _bits(rec[tri.clamp(min=0).long(), fused._ZUB])
        bucket = torch.where(tri >= 0, (zub >> zsh).to(torch.int64),
                             torch.tensor(SENTINEL, dtype=torch.int64))
        for i in range(tri.shape[1]):
            p = pos + i
            kk, oo = kz[:, i], ordc[:, i]
            for r in range(c):
                act = alive[r] & (p >= los[r]) & (p < his[r])
                take = act[:, None] & ((kk > key[r]) | (
                    (kk == key[r]) & (oo >= ordv[r])))
                key[r] = torch.where(take, kk, key[r])
                ordv[r] = torch.where(take, oo, ordv[r])
                idx[r] = torch.where(take, torch.tensor(p), idx[r])
                win = act & (p >= nb)
                rows += win.to(torch.int64)
                bmin[r] = torch.where(win, torch.minimum(bmin[r],
                                                         bucket[:, i]),
                                      bmin[r])
                end = act & ((p - los[r] + 1) % round_len == 0) & (
                    p + 1 < his[r])
                if bool(end.any()):
                    kmin = torch.maximum(key[r], ikey).min(dim=1).values
                    stop = end & (bmin[r] < SENTINEL) & (
                        ((bmin[r] + 2) << zsh) <= kmin)
                    alive[r] = alive[r] & ~stop
                    bmin[r] = torch.where(end, torch.tensor(SENTINEL),
                                          bmin[r])
        tris.append(tri)
        pos += tri.shape[1]
    # Rank 0 folds the parts in use in rank order.
    fk, fo, fi = key[0], ordv[0], idx[0]
    for r in range(1, c):
        take = (used > r)[:, None] & ((key[r] > fk) | (
            (key[r] == fk) & (ordv[r] >= fo)))
        fk = torch.where(take, key[r], fk)
        fo = torch.where(take, ordv[r], fo)
        fi = torch.where(take, idx[r], fi)
    if not tris:
        return fk, fo, torch.full_like(fk, -1), rows
    won = torch.gather(torch.cat(tris, 1), 1, fi.clamp(min=0))
    return fk, fo, torch.where(fi >= 0, won, torch.full_like(won, -1)), rows


def split_earlyz(c: int, min_part: int, round_len: int, scanned=None):
    """raster_tiles_earlyz_plain with K9's split scan (``scanned``: a list
    each call appends its (window rows scanned, rows present) to)."""
    def raster(rec, big_ids, n_big, pair_tri, ids, starts, counts,
               init_zkey, init_okey, zsh, tiles_x, tile_h, tile_w,
               out_fields=fused._OUT_FIELDS, max_count=None):
        px, py = fused._pixel_centres(ids, tiles_x, tile_h, tile_w)
        key, ordv, tri, rows = earlyz_split_scan(
            rec, big_ids, n_big, pair_tri, starts, counts, init_zkey,
            init_okey, zsh, px, py, c, min_part, round_len)
        if scanned is not None:
            scanned.append((int(rows.sum()), int(counts.sum())))
        return key, ordv, fused._resolve_plain(rec, tri, px, py, out_fields)
    return raster


@pytest.fixture(scope="module")
def inst():
    cases.cap_threads()
    return cases.jax_pass_of(*cases.instanced_scene())


def _capture(fn, calls):
    def run(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)
    return run


@pytest.fixture(scope="module")
def earlyz_calls(inst):
    """K9's calls of the test frame's early-z raster: one pass, and the
    three depth-chained passes of MULTI (continuing keys and orders)."""
    _, _, psetup, prec = inst
    calls = []
    for kw in (ONE_PASS, MULTI):
        fused.raster_fused(prec, psetup, W, H, tile_h=TH, tile_w=TW,
                           earlyz=True, raster_earlyz=_capture(
                               fused.raster_tiles_earlyz, calls), **kw)
    return calls


@pytest.fixture(scope="module")
def occluded_call():
    """K9's call on geometry where its break fires: a near occluder in the
    overflow list before 40 layers of far small triangles (windows of 320
    candidates, longer than a part's round at every round size)."""
    rec, setup = _occluded_layers(torch.device("cpu"))
    calls = []
    fused.raster_fused(rec, setup, OCC_W, OCC_H, earlyz=True,
                       max_candidates=512, overflow_cap=8, span_cap=4,
                       raster_earlyz=_capture(fused.raster_tiles_earlyz,
                                              calls))
    return calls[0]


def _earlyz_case(earlyz_calls, occluded_call, kind: str):
    if kind == "occluded":
        return [occluded_call]
    if kind == "occluded_again":
        # A second pass from the occluder's keys: every part holds them as
        # its bound, so a later part stops after its first round too.
        a, k = occluded_call
        zk, ok, _ = fused.raster_tiles_earlyz_plain(*a, **k)
        return [((*a[:7], zk, ok, *a[9:]), k)]
    if kind == "passes":
        return earlyz_calls[1:]
    a, k = earlyz_calls[0]
    a = list(a)
    if kind == "duplicated":
        # Every triangle twice: the copy (id + T, a larger draw order)
        # follows its original in the overflow list and every window.
        rec, big_ids, n_big, pair_tri, _, starts, counts = a[:7]
        t = rec.shape[0]
        copy = rec.clone()
        copy[:, fused._ID] = torch.where(rec[:, fused._ID] > 0,
                                         rec[:, fused._ID] + t,
                                         rec[:, fused._ID])
        nb = int(n_big[0])
        a[0] = torch.cat([rec, copy])
        a[1] = torch.stack([big_ids[:nb], big_ids[:nb] + t], 1).reshape(-1)
        a[2] = torch.tensor([2 * nb], dtype=torch.int32)
        a[3] = torch.stack([pair_tri, pair_tri + t], 1).reshape(-1)
        a[5], a[6] = 2 * starts, 2 * counts
    elif kind == "init_ties":
        # Continue the scan's own (key, ord): every covered pixel's winner
        # ties the initial value and must still replace it.
        zk, ok, _ = fused.raster_tiles_earlyz_plain(*a, **k)
        a[7], a[8] = zk, ok
    return [(tuple(a), k)]


@pytest.mark.parametrize("min_part,round_len", [(8, 8), (64, 32), (64, 128)],
                         ids=["parts8_rounds8", "parts64_rounds32",
                              "parts64_rounds128"])
@pytest.mark.parametrize("c", [1, 2, 8])
@pytest.mark.parametrize("kind", ["frame", "passes", "duplicated",
                                  "init_ties", "occluded", "occluded_again"])
def test_earlyz_split_equals_plain(earlyz_calls, occluded_call, kind, c,
                                   min_part, round_len):
    """K9's split scan with its break gives the plain version's zkey,
    okey and every plane; (64, 128) are the kernel's part and round."""
    scanned = []
    for a, k in _earlyz_case(earlyz_calls, occluded_call, kind):
        want = fused.raster_tiles_earlyz_plain(*a, **k)
        got = split_earlyz(c, min_part, round_len, scanned)(*a, **k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if kind in ("frame", "duplicated", "occluded"):
            hit = got[2][fused._OUT_FIELDS.index("idf")] >= 0.5
            assert float(hit.float().mean()) > 0.3
        if kind == "init_ties":
            assert torch.equal(got[0], a[7] & fused.LOW3)
        nb = int(a[2][0])
        total = nb + a[6].to(torch.int64)
        _, _, used = _parts(total, c, min_part)
        if c == 8 and kind == "frame":  # parts left empty, splits of 2+
            assert bool((used < c).any()) and bool((used > 1).any())
    rows, present = map(sum, zip(*scanned))
    assert rows <= present
    if kind == "occluded":
        # Behind the occluder (the overflow list, in rank 0's part) rank 0
        # stops at its first round's end; a later part's bound holds only
        # its own candidates, so it rarely stops. A part no longer than a
        # round has no round to skip.
        los, his, _ = _parts(nb + a[6].to(torch.int64), c, min_part)
        if bool((his[0] - los[0] > round_len).any()):
            assert rows < (present // 2 if c == 1 else present), (
                rows, present)
        else:
            assert rows == present, (rows, present)
    if kind == "occluded_again" and c == 2:
        # Both parts stop after their first round; in the first pass the
        # later part scans its whole range.
        first = []
        split_earlyz(c, min_part, round_len, first)(*occluded_call[0],
                                                    **occluded_call[1])
        assert rows < sum(r for r, _ in first), (rows, first)


@pytest.fixture(scope="module")
def pallas(inst):
    """The JAX package's raster (interpret mode) of the test frame, per
    (mode, capacities), computed once."""
    setup, jrec, _, _ = inst
    memo = {}

    def get(mode: str, kw_name: str):
        if (mode, kw_name) not in memo:
            kw = ONE_PASS if kw_name == "one_pass" else MULTI
            memo[mode, kw_name] = jfused.raster_fused_pallas(
                jrec, setup, W, H, tile_h=TH, tile_w=TW, interpret=True,
                **{mode: True}, **kw)
        return memo[mode, kw_name]

    return get


@pytest.mark.parametrize("kw_name", ["one_pass", "multi"])
@pytest.mark.parametrize("c", [1, 8])
def test_earlyz_split_raster_matches_pallas(inst, pallas, c, kw_name):
    """raster_fused over K9's split scan (one pass, and three chained
    passes) gives the JAX package's early-z raster."""
    _, _, psetup, prec = inst
    kw = ONE_PASS if kw_name == "one_pass" else MULTI
    got = fused.raster_fused(prec, psetup, W, H, tile_h=TH, tile_w=TW,
                             earlyz=True,
                             raster_earlyz=split_earlyz(c, 8, 8), **kw)
    cases.assert_raster_close(got, pallas("earlyz", kw_name))


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

def seek_round(w: int, nsub: int, parts: int, nrounds, g: int, j: int):
    """csrc/raster_fine.cu seek_round, line for line."""
    while g < nsub and j >= nrounds[g]:
        g += 1
        if g < nsub:
            d = (w - g + nsub) % nsub
            j = d if d < parts else 1 << 31
    return g, j


def warp_rounds(w: int, nsub: int, parts: int, nrounds) -> list:
    """The (subtile, round) pairs warp w scans, in its order."""
    parts = min(parts, nsub)
    g, j = seek_round(w, nsub, parts, nrounds, 0, w if w < parts else 1 << 31)
    out = []
    while g < nsub:
        out.append((g, j))
        g, j = seek_round(w, nsub, parts, nrounds, g, j + parts)
    return out


@pytest.mark.parametrize("parts", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nsub", [8, 4, 1])
def test_fine_rounds_dealt_once(parts, nsub):
    """Every round of every subtile goes to exactly one warp; with one
    part each warp takes its own subtile (the one-warp-per-subtile
    schedule), with nsub parts round j of subtile g goes to warp
    (g + j) mod nsub."""
    rng = np.random.default_rng(parts * 10 + nsub)
    for _ in range(20):
        nrounds = rng.integers(0, 20, nsub).tolist()
        nrounds[rng.integers(nsub)] = 0
        got = {}
        for w in range(nsub):
            rounds = warp_rounds(w, nsub, parts, nrounds)
            assert rounds == sorted(rounds)
            for gj in rounds:
                assert gj not in got
                got[gj] = w
        want = {(g, j) for g in range(nsub) for j in range(nrounds[g])}
        assert set(got) == want
        p = min(parts, nsub)
        for (g, j), w in got.items():
            assert w == (g + j % p) % nsub


def _corners(ids, tiles_x: int, tile_h: int, tile_w: int, nsub: int):
    """(K·nsub,) corner pixel centres x0, x1, y0, y1 of every subtile, as
    the kernel computes them."""
    sub_w = tile_w // nsub
    row, col = ids // tiles_x, ids % tiles_x
    g = torch.arange(nsub, dtype=torch.int32)
    x0 = (col[:, None] * tile_w + g[None, :] * sub_w).reshape(-1)
    y0 = (row * tile_h)[:, None].expand(-1, nsub).reshape(-1)
    f = torch.float32
    return ((x0.to(f) + 0.5), ((x0 + sub_w - 1).to(f) + 0.5),
            (y0.to(f) + 0.5), ((y0 + tile_h - 1).to(f) + 0.5))


def fine_split_scan(rec, big_ids, n_big, pair_tri, ids, starts, lb_al, cntk,
                    init_zkey, tiles_x: int, tile_h: int, tile_w: int,
                    culled=None):
    """K11's result per subtile: the packed (key, position) maximum over
    the initial key and the candidates the corner test keeps (every one
    where an initial key of the subtile is at or below the miss key).
    Returns (key, tri) in screen order; ``culled``: a list each call
    appends (candidates culled, culled ones covering a pixel, kept ones
    covering part of their subtile) to."""
    k, nsub = lb_al.shape
    sub_w = tile_w // nsub
    px, py = fused._pixel_centres(ids, tiles_x, tile_h, tile_w)

    def fine(t):
        return fused._fine_order(t, k, tile_h, nsub, sub_w)

    init = fine(init_zkey) & fused.LOW3
    can_cull = (init > MISS).all(dim=1)
    cx0, cx1, cy0, cy1 = _corners(ids, tiles_x, tile_h, tile_w, nsub)
    best = _packed(init, -1)
    tris, stats = [], [0, 0, 0]
    pos = 0
    for tri, co, ok, z in fused._plain_chunks(
            rec, big_ids, n_big, pair_tri,
            (starts[:, None] + lb_al).reshape(-1), cntk.reshape(-1),
            fine(px), fine(py)):
        may = torch.ones(tri.shape, dtype=torch.bool)
        for e in range(3):
            a, b, c = (co[..., fused._A + e], co[..., fused._B + e],
                       co[..., fused._C + e])
            corner = [a * x[:, None] + b * y[:, None] + c
                      for x in (cx0, cx1) for y in (cy0, cy1)]
            may &= torch.stack(corner).ge(0.0).any(dim=0)
        cull = can_cull[:, None] & ~may & (tri >= 0)
        covers = ok.any(dim=2)
        stats[0] += int(cull.sum())
        stats[1] += int((cull & covers).sum())
        stats[2] += int((~cull & covers & ~ok.all(dim=2)).sum())
        key = _bits(z) & fused.LOW3
        idx = pos + torch.arange(tri.shape[1])
        packed = torch.where(cull[..., None], torch.iinfo(torch.int64).min,
                             _packed(key, idx[None, :, None]))
        best = torch.maximum(best, packed.max(dim=1).values)
        tris.append(tri)
        pos += tri.shape[1]
    if culled is not None:
        culled.append(tuple(stats))
    key = (best >> 32).to(torch.int32)
    i = (best & 0xFFFFFFFF) - 1
    if tris:
        won = torch.gather(torch.cat(tris, 1), 1, i.clamp(min=0))
        tri = torch.where(i >= 0, won, torch.full_like(won, -1))
    else:
        tri = torch.full_like(key, -1)
    return (fused._screen_order(key, k, tile_h, nsub, sub_w),
            fused._screen_order(tri, k, tile_h, nsub, sub_w))


def split_fine(culled=None):
    """raster_tiles_fine_plain with K11's culled maximum."""
    def raster(rec, big_ids, n_big, pair_tri, ids, starts, lb_al, cntk,
               init_zkey, tiles_x, tile_h, tile_w,
               out_fields=fused._OUT_FIELDS):
        key, tri = fine_split_scan(rec, big_ids, n_big, pair_tri, ids,
                                   starts, lb_al, cntk, init_zkey, tiles_x,
                                   tile_h, tile_w, culled)
        px, py = fused._pixel_centres(ids, tiles_x, tile_h, tile_w)
        return key, fused._resolve_plain(rec, tri, px, py, out_fields)
    return raster


@pytest.fixture(scope="module")
def fine_call(inst):
    """K11's call (pass 0) of the test frame's fine-bin raster."""
    _, _, psetup, prec = inst
    calls = []
    fused.raster_fused(prec, psetup, W, H, tile_h=TH, tile_w=TW,
                       fine_bins=True, raster_fine=_capture(
                           fused.raster_tiles_fine, calls), **ONE_PASS)
    return calls[0]


def _fine_case(fine_call, kind: str):
    a, k = fine_call
    a = list(a)
    if kind == "duplicated":
        rec, big_ids, n_big, pair_tri, _, starts, lb_al, cntk = a[:8]
        t = rec.shape[0]
        nb = int(n_big[0])
        a[0] = torch.cat([rec, rec])
        a[1] = torch.stack([big_ids[:nb], big_ids[:nb] + t], 1).reshape(-1)
        a[2] = torch.tensor([2 * nb], dtype=torch.int32)
        a[3] = torch.stack([pair_tri, pair_tri + t], 1).reshape(-1)
        a[5], a[6], a[7] = 2 * starts, 2 * lb_al, 2 * cntk
    elif kind == "init_ties":
        a[8] = fused.raster_tiles_fine_plain(*a, **k)[0]
    elif kind == "miss_init":
        # Initial keys at the miss key: a candidate's miss ties them and
        # wins, so no candidate may be skipped. (Like the plain version,
        # the replay also scans the dead rows past a short window up to
        # the longest one, whose misses win such ties too; the kernels
        # stop at each window's end. A frame's initial keys are 0 or an
        # earlier pass's, never at the miss key.)
        a[8] = torch.full_like(a[8], MISS)
    return tuple(a), k


@pytest.mark.parametrize("kind", ["frame", "duplicated", "init_ties",
                                  "miss_init"])
def test_fine_split_equals_plain(fine_call, kind):
    """K11's culled maximum gives the plain version's keys and planes;
    no culled candidate covers a pixel of its subtile, and overflow
    triangles that cover part of a subtile only are kept."""
    a, k = _fine_case(fine_call, kind)
    culled = []
    got = split_fine(culled)(*a, **k)
    want = fused.raster_tiles_fine_plain(*a, **k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n_culled, culled_cover, partial = culled[0]
    assert culled_cover == 0
    assert partial > 0
    if kind == "miss_init":
        assert n_culled == 0
        assert bool((got[0] == MISS).any())  # misses won ties with it
    else:
        assert n_culled > 0
    if kind == "init_ties":
        assert torch.equal(got[0], a[8] & fused.LOW3)


def test_fine_overflow_partial_cover(fine_call):
    """The test frame's overflow list holds a triangle that covers part of
    a subtile only, and one the corner test skips for some subtile."""
    a, _ = fine_call
    rec, big_ids, n_big, _, ids, _, lb_al, _, init, tx, th, tw = a[:12]
    nb = int(n_big[0])
    assert nb > 0
    culled = []
    zero = torch.zeros_like(lb_al)
    fine_split_scan(rec, big_ids, n_big, big_ids[:0], ids,
                    torch.zeros_like(ids), zero, zero, init, tx, th, tw,
                    culled)
    n_culled, culled_cover, partial = culled[0]
    assert n_culled > 0 and culled_cover == 0 and partial > 0


def test_fine_split_raster_matches_pallas(inst, pallas):
    """raster_fused over K11's culled maximum gives the JAX package's
    fine-bin raster (K11 runs pass 0 only; later passes are K1's)."""
    _, _, psetup, prec = inst
    got = fused.raster_fused(prec, psetup, W, H, tile_h=TH, tile_w=TW,
                             fine_bins=True, raster_fine=split_fine(),
                             **ONE_PASS)
    cases.assert_raster_close(got, pallas("fine_bins", "one_pass"))
