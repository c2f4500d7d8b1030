"""Fused raster + attribute resolve, and the depth-tested overlay composite
(port of ``bibim_tpu.ops.fused``).

Pipeline of one raster pass:

1. :func:`build_record_table_planar` packs every triangle's edge/depth
   coefficients and corner attributes into one (T, REC_CH) float32 row.
2. :func:`bin_pairs` expands (triangle, tile) pairs from each bbox, sorts
   them (kernel K3, ``ops.sort``) and cuts per-tile [start, count) windows;
   triangles spanning more than ``span_cap`` tiles go to a shared overflow
   ("big") list that every tile tests first.
3. :func:`raster_tiles` (kernel K1) scans, per 8×128 screen tile, the
   overflow list then the tile's window in sorted order with homogeneous
   edge tests and the reversed-Z packed depth key ``(bits(z) & ~7)``
   accepted with ``>=`` (the later candidate wins a tie), then reads the
   winner's record and writes perspective-correct attribute planes.

:func:`overlay_tiles` (kernel K4) runs the same scan over a compacted list
of live tiles, continuing the scene's depth keys, and composites the
winner's flat colour into the LDR planes.

Every pixel quantity is a planar (NT, NPX) tensor, NPX = tile_h·tile_w, tile
index = row·tiles_x + col, pixel index = y·tile_w + x.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bibim_tpu_torch import _build
from bibim_tpu_torch.ops.raster import PlanarSetup
from bibim_tpu_torch.ops.sort import (
    sort_keys,
    sort_pairs,
    sort_pairs_z,
    zorder_bits,
)
from bibim_tpu_torch.utils import profiling

CHUNK = 8
LOW3 = ~7  # clears the 3 low bits of a packed depth key

# Record channel layout (the reference's, rows padded to REC_CH floats).
_A, _B, _C = 0, 3, 6  # edge coefficients A0A1A2 B0B1B2 C0C1C2
_ZC, _WC = 9, 12  # z / w interpolation coefficients
_ID = 15  # triangle id + 1 (0 = miss)
_U, _V = 16, 19  # uv corners
_N = 22  # normal corners, axis-major: nx0 nx1 nx2 ny0 .. nz2
_T = 31  # tangent corners
_W = 40  # world-position corners
_COL = 49  # vertex-colour corners
_MAT = 58  # material id (corner-0 vertex)
_ZUB = 59  # conservative NDC-depth upper bound
_USED = 60
REC_CH = 64  # row width: 60 used channels padded to 256 bytes

SPAN_DENSE = 2  # dense expansion slots per triangle in span-class binning
NSUB_FINE = 8  # fine_bins subtiles per coarse tile ((tile_w / 8) × tile_h)

# Kernel output planes beyond the int32 depth-key plane, in kernel order.
_OUT_FIELDS = (
    "depth", "idf", "u", "v", "nx", "ny", "nz", "tx", "ty", "tz",
    "wx", "wy", "wz", "cr", "cg", "cb", "matf", "b0", "b1",
)


class FusedPixels(NamedTuple):
    """Tiled-planar per-pixel raster output; every tensor is (NT, NPX)."""

    tri_id: torch.Tensor  # int32, -1 = miss
    depth: torch.Tensor  # reversed-Z depth (0 = far/clear)
    bary: tuple
    uv: tuple
    normal: tuple
    tangent: tuple
    world: tuple
    color: tuple
    mat_id: torch.Tensor  # int32


class BinDiag(NamedTuple):
    """Capacity diagnostics (0-dim int tensors): non-zero means geometry
    was dropped — ``utils.validation.check_bin_diag`` raises on it."""

    dropped_overflow: torch.Tensor
    dropped_cap: torch.Tensor
    dropped_pairs: torch.Tensor
    dropped_tiles: torch.Tensor


def sum_diags(diags) -> BinDiag:
    return BinDiag(*(sum(d[i] for d in diags) for i in range(4)))


# ---------------------------------------------------------------------------
# Record tables
# ---------------------------------------------------------------------------

def build_record_table_planar(setup: PlanarSetup, soup) -> torch.Tensor:
    """(T, REC_CH) records from corner-planar setup + soup; culled rows are
    zeroed so a stray candidate can never cover a pixel."""
    t = setup.valid.shape[0]
    dev = setup.valid.device
    ids = torch.arange(t, dtype=torch.float32, device=dev) + 1.0
    planes = [
        *setup.edge_a, *setup.edge_b, *setup.edge_c,
        *setup.z_coef, *setup.w_coef,
        ids,
        *soup.uv[0], *soup.uv[1],
        *soup.normal[0], *soup.normal[1], *soup.normal[2],
        *soup.tangent[0], *soup.tangent[1], *soup.tangent[2],
        *soup.world[0], *soup.world[1], *soup.world[2],
        *soup.color[0], *soup.color[1], *soup.color[2],
        soup.mat,
        (setup.zub if setup.zub is not None
         else torch.zeros((t,), dtype=torch.float32, device=dev)),
    ]
    assert len(planes) == _USED
    rec = torch.zeros((t, REC_CH), dtype=torch.float32, device=dev)
    rec[:, :_USED] = torch.stack(planes, dim=1)
    return (rec * setup.valid.to(torch.float32)[:, None]).contiguous()


def build_record_table(setup: PlanarSetup, tris: torch.Tensor, uv, normal,
                       tangent, world, color, mat_id=None,
                       sequential: bool = False) -> torch.Tensor:
    """Records for an indexed mesh: attributes are (V, k) vertex arrays
    gathered per corner by ``tris`` (T, 3); ``sequential``: ``tris`` is an
    arange (a de-indexed mesh), the corners a reshape."""
    v = uv.shape[0]
    dev = uv.device
    if mat_id is None:
        mat_id = torch.zeros((v,), dtype=torch.int32, device=dev)
    vert = torch.cat([uv, normal, tangent, world, color,
                      mat_id.to(torch.float32)[:, None]], dim=1)  # (V, 15)
    va = vert.reshape(-1, 3, 15) if sequential else vert[tris.long()]
    soup_like = _CornerSoup(
        uv=(tuple(va[:, c, 0] for c in range(3)),
            tuple(va[:, c, 1] for c in range(3))),
        normal=tuple(tuple(va[:, c, 2 + k] for c in range(3))
                     for k in range(3)),
        tangent=tuple(tuple(va[:, c, 5 + k] for c in range(3))
                      for k in range(3)),
        world=tuple(tuple(va[:, c, 8 + k] for c in range(3))
                    for k in range(3)),
        color=tuple(tuple(va[:, c, 11 + k] for c in range(3))
                    for k in range(3)),
        mat=va[:, 0, 14],
    )
    return build_record_table_planar(setup, soup_like)


def shift_record_table_y(rec: torch.Tensor, y0) -> torch.Tensor:
    """Records rebased to the rows of a horizontal band that starts at
    frame row ``y0``: E(px, py_frame) = A·px + B·(py_band + y0) + C, so
    C += B·y0 on the three edges and on the z and w planes' constant
    terms lets the unmodified raster scan the band in band-local rows.
    The product and the sum round apart; culled (zero) rows stay zero."""
    y0 = float(y0)
    out = rec.clone()
    out[:, _C:_C + 3] = rec[:, _C:_C + 3] + rec[:, _B:_B + 3] * y0
    cz = [_ZC + 2, _WC + 2]
    out[:, cz] = rec[:, cz] + rec[:, [_ZC + 1, _WC + 1]] * y0
    return out


class _CornerSoup(NamedTuple):
    uv: tuple
    normal: tuple
    tangent: tuple
    world: tuple
    color: tuple
    mat: torch.Tensor


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def bin_pairs(setup: PlanarSetup, width: int, height: int, tile_h: int,
              tile_w: int, span_cap: int = 16, overflow_cap: int = 64,
              max_candidates: int = 320, pair_budget: int | None = None,
              span_mid_cap: int | None = None, zorder: bool = False,
              sort=sort_keys):
    """Sort-based sparse binning → per-tile [start, count) windows.

    Each triangle expands its bbox tiles into (tile, tri) pair slots; the
    sorted pair list groups pairs per tile in draw order. Triangles spanning
    more than ``span_cap`` tiles go to the overflow list (``big_ids``).
    ``span_mid_cap`` enables span-class binning: every triangle expands only
    SPAN_DENSE slots, and the few spanning (SPAN_DENSE, span_cap] tiles go
    through a compacted list of that capacity — same sorted pair set, a
    smaller sort. ``zorder`` (with ``setup.zub``) orders each tile's pairs
    near-first by conservative depth bucket (:func:`sort_pairs_z`), the
    early-z raster's order.

    Returns (sorted_tri (P,), starts (NT,), counts (NT,) clamped to
    max_candidates, big_ids (overflow_cap,), n_big (0-dim), diag, tiles_y,
    tiles_x), all int32.
    """
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    nt = tiles_x * tiles_y
    dev = setup.valid.device
    i32 = torch.int32

    bx0, by0, bx1, by1 = setup.bbox
    tx0 = bx0 // tile_w
    ty0 = by0 // tile_h
    tx1 = bx1 // tile_w
    ty1 = by1 // tile_h
    span_w = tx1 - tx0 + 1
    area = span_w * (ty1 - ty0 + 1)
    t = area.shape[0]
    iota = torch.arange(t, dtype=i32, device=dev)

    small = setup.valid & (area <= span_cap)
    big = setup.valid & (area > span_cap)
    n_big_all = big.sum(dtype=i32)
    dropped_mid = torch.zeros((), dtype=i32, device=dev)

    def slot_tile(k, live_k):
        # floor(k / span_w) as a compare-sum ladder (same as the reference)
        dy = torch.zeros_like(span_w)
        for m in range(1, k + 1):
            dy = dy + (m * span_w <= k).to(i32)
        dx = k - dy * span_w
        return torch.where(live_k, (ty0 + dy) * tiles_x + (tx0 + dx),
                           torch.full_like(span_w, nt))

    neg_fill = -(1 << 30)
    if span_mid_cap is not None and span_cap > SPAN_DENSE:
        dense = small & (area <= SPAN_DENSE)
        tile_d = torch.stack([slot_tile(k, dense & (k < area))
                              for k in range(SPAN_DENSE)])
        tri_d = iota[None, :].expand(SPAN_DENSE, t)

        # One top-k compacts both the overflow and the mid class: big
        # triangles (ascending id) rank before mid ones (ascending id).
        mid = small & (area > SPAN_DENSE)
        big_base = 3 << 28
        mid_base = 1 << 28
        key = torch.where(big, big_base - iota,
                          torch.where(mid, mid_base - iota,
                                      torch.full_like(iota, neg_fill)))
        k_sel = overflow_cap + span_mid_cap
        k_top = min(k_sel, t)
        top = torch.topk(key, k_top).values
        if k_top < k_sel:
            top = torch.cat([top, torch.full((k_sel - k_top,), neg_fill,
                                             dtype=i32, device=dev)])
        big_ids = torch.where(top[:overflow_cap] > (2 << 28),
                              big_base - top[:overflow_cap],
                              torch.full_like(top[:overflow_cap], -1))
        n_big = torch.clamp(n_big_all, max=overflow_cap)
        mid_win = top[n_big.long()
                      + torch.arange(span_mid_cap, device=dev)]
        mid_ids = torch.where((mid_win > 0) & (mid_win <= mid_base),
                              mid_base - mid_win, torch.full_like(mid_win, -1))
        msel = torch.clamp(mid_ids, min=0)
        mvalid = mid_ids >= 0
        tx0m = tx0[msel]
        ty0m = ty0[msel]
        span_w_m = torch.clamp(span_w[msel], min=1)
        area_m = torch.where(mvalid, area[msel], torch.zeros_like(msel))
        km = torch.arange(span_cap, dtype=i32, device=dev)
        dxm = km[None, :] % span_w_m[:, None]
        dym = km[None, :] // span_w_m[:, None]
        tile_m = (ty0m[:, None] + dym) * tiles_x + (tx0m[:, None] + dxm)
        live_m = mvalid[:, None] & (km[None, :] < area_m[:, None])
        tile_m = torch.where(live_m, tile_m, torch.full_like(tile_m, nt))
        tri_m = msel[:, None].expand(span_mid_cap, span_cap)
        flat_tile = torch.cat([tile_d.reshape(-1), tile_m.reshape(-1)])
        tri_of_pair = torch.cat([tri_d.reshape(-1), tri_m.reshape(-1)])
        if zorder and setup.zub is not None:
            zub_m = torch.where(mvalid, setup.zub[msel],
                                torch.zeros_like(setup.zub[msel]))
            flat_zub = torch.cat([
                setup.zub[None, :].expand(SPAN_DENSE, t).reshape(-1),
                zub_m[:, None].expand(span_mid_cap, span_cap).reshape(-1)])
        total_mid = torch.where(mid, area, torch.zeros_like(area)).sum(
            dtype=i32)
        dropped_mid = total_mid - area_m.sum(dtype=i32)
    else:
        tile = torch.stack([slot_tile(k, small & (k < area))
                            for k in range(span_cap)])
        flat_tile = tile.reshape(-1)
        tri_of_pair = iota[None, :].expand(span_cap, t).reshape(-1)
        if zorder and setup.zub is not None:
            flat_zub = setup.zub[None, :].expand(span_cap, t).reshape(-1)
        neg = torch.where(big, -iota, torch.full_like(iota, neg_fill))
        k_top = min(overflow_cap, t)
        top = torch.topk(neg, k_top).values
        big_ids = torch.where(top > neg_fill, -top, torch.full_like(top, -1))
        if k_top < overflow_cap:
            big_ids = torch.cat([big_ids, torch.full(
                (overflow_cap - k_top,), -1, dtype=i32, device=dev)])
        n_big = torch.clamp(n_big_all, max=overflow_cap)

    if zorder and setup.zub is not None:
        sorted_tile, sorted_tri = sort_pairs_z(
            flat_tile, flat_zub, tri_of_pair, nt, t_count=t,
            bits=zorder_bits(nt, t), sort=sort)
    else:
        sorted_tile, sorted_tri = sort_pairs(flat_tile.contiguous(),
                                             tri_of_pair.contiguous(), nt,
                                             t_count=t, sort=sort)
    boundaries = torch.searchsorted(
        sorted_tile, torch.arange(nt + 1, dtype=i32, device=dev),
        out_int32=True)
    starts = boundaries[:-1]
    counts_raw = boundaries[1:] - starts
    counts = torch.clamp(counts_raw, max=max_candidates)
    dropped_pairs = torch.zeros((), dtype=i32, device=dev)
    if pair_budget is not None and sorted_tri.shape[0] > pair_budget:
        # Live pairs sort before the sentinel tail: slicing to the budget
        # keeps them all unless the scene exceeds it, which diag reports.
        dropped_pairs = torch.clamp(boundaries[-1] - pair_budget, min=0)
        sorted_tri = sorted_tri[:pair_budget]
        starts = torch.clamp(starts, max=pair_budget)
        counts = torch.minimum(counts, pair_budget - starts)
    diag = BinDiag(
        dropped_overflow=torch.clamp(n_big_all - overflow_cap, min=0),
        dropped_cap=torch.clamp(counts_raw - max_candidates, min=0).sum(
            dtype=i32),
        dropped_pairs=dropped_pairs + dropped_mid,
        dropped_tiles=torch.zeros((), dtype=i32, device=dev),
    )
    return (sorted_tri.contiguous(), starts.contiguous(), counts.contiguous(),
            big_ids.contiguous(), n_big.reshape(1).contiguous(), diag,
            tiles_y, tiles_x)


# ---------------------------------------------------------------------------
# Shared plain-version pieces (the kernels' semantics as tensor ops)
# ---------------------------------------------------------------------------

def _pixel_centres(ids: torch.Tensor, tiles_x: int, tile_h: int,
                   tile_w: int):
    npx = tile_h * tile_w
    pix = torch.arange(npx, dtype=torch.int32, device=ids.device)
    row = ids // tiles_x
    col = ids % tiles_x
    px = ((pix % tile_w)[None, :] + (col * tile_w)[:, None]).to(
        torch.float32) + 0.5
    py = ((pix // tile_w)[None, :] + (row * tile_h)[:, None]).to(
        torch.float32) + 0.5
    return px, py


def _plain_chunks(rec, big_ids, n_big, pair_tri, starts, counts, px, py):
    """Every slot's candidate sequence (overflow list, then the window) in
    CHUNK-row steps: yields (tri (K, CHUNK) int32, -1 = dead row; the rows'
    (K, CHUNK, 16) record heads; ok (K, CHUNK, NPX) coverage inside the
    depth range; z (K, CHUNK, NPX) with -1 where not ok)."""
    dev = rec.device
    nb = n_big.reshape(()).to(torch.int64)
    total = nb + counts.to(torch.int64)
    n_iter = int(total.max()) if total.numel() else 0
    oc = max(big_ids.shape[0], 1)
    p_len = max(pair_tri.shape[0], 1)
    big_src = big_ids if big_ids.shape[0] else torch.full(
        (1,), -1, dtype=torch.int32, device=dev)
    pair_src = pair_tri if pair_tri.shape[0] else torch.zeros(
        (1,), dtype=torch.int32, device=dev)
    pxe, pye = px[:, None, :], py[:, None, :]
    for c0 in range(0, n_iter, CHUNK):
        c = c0 + torch.arange(CHUNK, dtype=torch.int64, device=dev)
        is_big = c < nb
        from_big = big_src[torch.clamp(c, max=oc - 1)]
        pidx = torch.clamp(starts.to(torch.int64)[:, None] + c[None, :] - nb,
                           0, p_len - 1)
        tri = torch.where(is_big[None, :], from_big[None, :], pair_src[pidx])
        live = (c[None, :] < total[:, None]) & (tri >= 0)
        tri = torch.where(live, tri, torch.full_like(tri, -1))
        co = rec[torch.clamp(tri, min=0).long(), :_ID + 1]  # (K, CHUNK, 16)
        co = torch.where(live[..., None], co, torch.zeros_like(co))

        def plane(j):
            return (co[..., j, None] * pxe + co[..., j + 3, None] * pye
                    + co[..., j + 6, None])

        e0, e1, e2 = plane(_A), plane(_A + 1), plane(_A + 2)
        zn = (co[..., _ZC, None] * pxe + co[..., _ZC + 1, None] * pye
              + co[..., _ZC + 2, None])
        wn = (co[..., _WC, None] * pxe + co[..., _WC + 1, None] * pye
              + co[..., _WC + 2, None])
        ok = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (wn > 0.0)
              & (zn >= 0.0) & (zn <= wn))
        z = zn * (1.0 / torch.where(wn == 0.0, torch.ones_like(wn), wn))
        yield tri, co, ok, torch.where(ok, z, torch.full_like(z, -1.0))


def _scan_plain(rec, big_ids, n_big, pair_tri, starts, counts, init_key,
                px, py):
    """Coverage + depth scan of every slot's candidate sequence (overflow
    list, then the window) in CHUNK-row steps: within a chunk the highest
    ``(masked key) | row`` wins (later row on ties), across chunks the
    running key is replaced on ``>=`` — the reference kernel's rule.
    Returns (best_key, best_tri) (K, NPX) int32; best_tri -1 = no winner."""
    k_slots, npx = init_key.shape
    best_key = init_key & LOW3
    best = torch.full((k_slots, npx), -1, dtype=torch.int32,
                      device=rec.device)
    if k_slots == 0 or rec.shape[0] == 0:
        return best_key, best
    row_ix = torch.arange(CHUNK, dtype=torch.int32, device=rec.device)
    for tri, _, _, z in _plain_chunks(rec, big_ids, n_big, pair_tri, starts,
                                      counts, px, py):
        key = (z.view(torch.int32) & LOW3) | row_ix[None, :, None]
        kmax = key.max(dim=1).values  # (K, NPX)
        kz = kmax & LOW3
        accept = kz >= best_key
        win_tri = torch.gather(tri, 1, (kmax & 7).long())
        best = torch.where(accept, win_tri, best)
        best_key = torch.where(accept, kz, best_key)
    return best_key, best


def _scan_plain_ord(rec, big_ids, n_big, pair_tri, starts, counts, init_key,
                    init_ord, px, py):
    """The early-z scan's result (K9): per pixel the lexicographic argmax
    of (masked depth key, draw order) over the initial (key, ord) and every
    candidate, where a candidate's ord is its record's _ID (triangle id +
    1) if it covers the pixel and -1 if not; in each chunk the reference's
    ``_chunk_test_ord``. The early break only skips candidates that cannot
    win, so the whole set is scanned here. Returns (best_key int32,
    best_ord float32, best_tri int32 (-1 = no candidate won)), each
    (K, NPX)."""
    k_slots, npx = init_key.shape
    best_key = init_key & LOW3
    best_ord = init_ord.clone()
    best = torch.full((k_slots, npx), -1, dtype=torch.int32,
                      device=rec.device)
    if k_slots == 0 or rec.shape[0] == 0:
        return best_key, best_ord, best
    row_ix = torch.arange(CHUNK, dtype=torch.int32, device=rec.device)
    neg = torch.tensor(-1.0, dtype=torch.float32, device=rec.device)
    for tri, co, ok, z in _plain_chunks(rec, big_ids, n_big, pair_tri,
                                        starts, counts, px, py):
        kz = z.view(torch.int32) & LOW3  # (K, CHUNK, NPX)
        ordc = torch.where(ok, co[..., _ID, None], neg)
        kmax = kz.max(dim=1, keepdim=True).values
        omax = torch.where(kz == kmax, ordc, neg).max(dim=1,
                                                       keepdim=True).values
        rsel = (kz == kmax) & (ordc == omax)
        ridx = torch.where(rsel, row_ix[None, :, None],
                           torch.full_like(kz, -1)).max(dim=1).values
        kmax, omax = kmax[:, 0], omax[:, 0]
        accept = (kmax > best_key) | ((kmax == best_key)
                                      & (omax >= best_ord))
        win_tri = torch.gather(tri, 1, ridx.long())
        best = torch.where(accept, win_tri, best)
        best_key = torch.where(accept, kmax, best_key)
        best_ord = torch.where(accept, omax, best_ord)
    return best_key, best_ord, best


def _winner_channels(rec, best):
    """r(ch): the winning record's channel per pixel, 0 where no winner."""
    hit = best >= 0
    idx = torch.clamp(best, min=0).long()

    def r(ch):
        v = rec[:, ch][idx] if rec.shape[0] else torch.zeros_like(
            best, dtype=torch.float32)
        return torch.where(hit, v, torch.zeros_like(v))

    return r


def _bary(r, px, py):
    e = [r(_A + k) * px + r(_B + k) * py + r(_C + k) for k in range(3)]
    esum = e[0] + e[1] + e[2]
    inv = 1.0 / torch.where(esum == 0.0, torch.ones_like(esum), esum)
    return e, inv


# ---------------------------------------------------------------------------
# K1: raster + resolve
# ---------------------------------------------------------------------------

def _resolve_plain(rec, best, px, py, out_fields):
    """(len(out_fields), K, NPX) planes from each pixel's winning triangle
    (``best``, -1 = none: every plane 0)."""
    r = _winner_channels(rec, best)
    idf = r(_ID)
    hit = idf >= 0.5
    zero = torch.zeros_like(idf)
    e, inv = _bary(r, px, py)
    b = [torch.where(hit, e[k] * inv, zero) for k in range(3)]

    def depth():
        zn = r(_ZC) * px + r(_ZC + 1) * py + r(_ZC + 2)
        wn = r(_WC) * px + r(_WC + 1) * py + r(_WC + 2)
        return torch.where(
            hit, zn * (1.0 / torch.where(wn == 0.0, torch.ones_like(wn), wn)),
            zero)

    def blend(base):
        return r(base) * b[0] + r(base + 1) * b[1] + r(base + 2) * b[2]

    vals = {
        "depth": depth, "idf": lambda: idf,
        "u": lambda: blend(_U), "v": lambda: blend(_V),
        "nx": lambda: blend(_N), "ny": lambda: blend(_N + 3),
        "nz": lambda: blend(_N + 6),
        "tx": lambda: blend(_T), "ty": lambda: blend(_T + 3),
        "tz": lambda: blend(_T + 6),
        "wx": lambda: blend(_W), "wy": lambda: blend(_W + 3),
        "wz": lambda: blend(_W + 6),
        "cr": lambda: blend(_COL), "cg": lambda: blend(_COL + 3),
        "cb": lambda: blend(_COL + 6),
        "matf": lambda: r(_MAT), "b0": lambda: b[0], "b1": lambda: b[1],
    }
    if out_fields:
        return torch.stack([vals[f]() for f in out_fields])
    return torch.zeros((0,) + idf.shape, dtype=torch.float32,
                       device=idf.device)


def raster_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                       init_zkey, tiles_x: int, tile_h: int, tile_w: int,
                       out_fields: tuple = _OUT_FIELDS,
                       max_count: int | None = None):
    """Plain version of K1. Slot s rasterizes screen tile ``ids[s]`` from
    the overflow list (``big_ids[:n_big]``) and then
    ``pair_tri[starts[s] : starts[s] + counts[s]]``, continuing the
    depth keys ``init_zkey[s]``. ``max_count``, the static cap on
    ``counts``, only sizes the kernel's launch (:func:`raster_cluster`).
    Returns (zkey (K, NPX) int32, fields (len(out_fields), K, NPX)
    float32)."""
    px, py = _pixel_centres(ids, tiles_x, tile_h, tile_w)
    best_key, best = _scan_plain(rec, big_ids, n_big, pair_tri, starts,
                                 counts, init_zkey, px, py)
    return best_key, _resolve_plain(rec, best, px, py, out_fields)


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_common(rec, big_ids, n_big, pair_tri, ids, starts, counts):
    dev = rec.device
    i32 = torch.int32
    _check("rec", rec, torch.float32, dev)
    if rec.ndim != 2 or rec.shape[1] != REC_CH:
        raise ValueError(f"rec: expected (T, {REC_CH}), got "
                         f"{tuple(rec.shape)}")
    k = ids.shape[0]
    _check("big_ids", big_ids, i32, dev)
    _check("n_big", n_big, i32, dev, (1,))
    _check("pair_tri", pair_tri, i32, dev)
    _check("ids", ids, i32, dev, (k,))
    _check("starts", starts, i32, dev, (k,))
    _check("counts", counts, i32, dev, (k,))
    return k


def _field_mask(out_fields) -> int:
    mask = 0
    for f in out_fields:
        mask |= 1 << _OUT_FIELDS.index(f)
    if tuple(f for f in _OUT_FIELDS if mask >> _OUT_FIELDS.index(f) & 1) \
            != tuple(out_fields):
        raise ValueError("out_fields must follow _OUT_FIELDS order")
    return mask


# K1 and K9 split a slot's window over the blocks of a thread-block cluster
# (csrc/raster.cu, csrc/raster_earlyz.cu) when a launch leaves SMs idle:
# each part keeps at least CLUSTER_MIN_PART window candidates (the
# kernels' MIN_PART: a shorter sequence is scanned by one block; K1's tail
# cuts its sequences into parts of exactly that length), and the launch
# stays within
# CLUSTER_MAX_BLOCKS blocks — five waves of the 4 blocks (64 registers ×
# 256 threads) each of an H100's 132 SMs holds.
CLUSTER_SIZES = (1, 2, 4, 8)
CLUSTER_MIN_PART = 64
CLUSTER_MAX_BLOCKS = 5 * 4 * 132


def raster_cluster(k: int, max_count: int | None) -> int:
    """K1's and K9's cluster size for ``k`` slots whose windows hold at most
    ``max_count`` candidates, from these static numbers alone (no device
    read): the largest size that keeps every part at least
    CLUSTER_MIN_PART candidates long and the launch within
    CLUSTER_MAX_BLOCKS blocks; 1 without a ``max_count``."""
    if max_count is None:
        return 1
    return max(c for c in CLUSTER_SIZES
               if c == 1 or (max_count >= c * CLUSTER_MIN_PART
                             and k * c <= CLUSTER_MAX_BLOCKS))


def raster_tiles(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                 init_zkey, tiles_x: int, tile_h: int, tile_w: int,
                 out_fields: tuple = _OUT_FIELDS,
                 max_count: int | None = None, cluster: int | None = None):
    """K1 wrapper (csrc/raster.cu); same contract as
    :func:`raster_tiles_plain`, which it runs only for CPU tensors.
    ``cluster`` overrides :func:`raster_cluster`'s size (a measurement
    knob; any size gives the same result)."""
    k = _check_common(rec, big_ids, n_big, pair_tri, ids, starts, counts)
    npx = tile_h * tile_w
    _check("init_zkey", init_zkey, torch.int32, rec.device, (k, npx))
    if rec.device.type == "cpu":
        return raster_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts,
                                  counts, init_zkey, tiles_x, tile_h, tile_w,
                                  out_fields)
    if rec.device.type != "cuda":
        raise RuntimeError(f"raster_tiles: unsupported device {rec.device}")
    if npx > _build.MAX_TILE_PIXELS:
        raise ValueError(f"raster_tiles: tiles of {npx} px exceed "
                         f"{_build.MAX_TILE_PIXELS}")
    if cluster is None:
        cluster = raster_cluster(k, max_count)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"raster_tiles: cluster {cluster} not in "
                         f"{CLUSTER_SIZES}")
    if rec.data_ptr() % 16:
        raise ValueError("raster_tiles: rec must be 16-byte aligned")
    mask = _field_mask(out_fields)
    zkey = torch.empty((k, npx), dtype=torch.int32, device=rec.device)
    fields = torch.empty((len(out_fields), k, npx), dtype=torch.float32,
                         device=rec.device)
    if k == 0:
        return zkey, fields
    p = _build.ptr
    err = _build.library().bb_raster(
        p(rec), p(big_ids), p(n_big), big_ids.shape[0], p(pair_tri),
        pair_tri.shape[0], p(ids), p(starts), p(counts), p(init_zkey),
        k, tiles_x, tile_h, tile_w, REC_CH, ctypes.c_uint(mask), cluster,
        p(zkey), p(fields), _build.stream_ptr(rec.device))
    _build.check(err, "raster")
    raster_tiles.launches += 1
    return zkey, fields


raster_tiles.launches = 0


# ---------------------------------------------------------------------------
# K1's tail: the candidates past the first window, merged in place
# ---------------------------------------------------------------------------

def raster_tiles_tail_plain(rec, pair_tri, ids, starts, counts, zkey,
                            fields, tiles_x: int, tile_h: int, tile_w: int,
                            out_fields: tuple = _OUT_FIELDS, row0: int = 0):
    """Plain version of K1's tail. Slot s scans
    ``pair_tri[starts[s] : starts[s] + counts[s]]`` (no overflow rows;
    ``counts[s]`` 0: a dead slot) over frame tile ``ids[s]``, continuing
    the keys of the frame's plane row ``ids[s] - row0·tiles_x`` in
    ``zkey`` ((NT, NPX) int32), and merges into the frame's planes in
    place: the key where a candidate won, and ``fields``' planes
    ((len(out_fields), NT, NPX) float32, ``"idf"`` among them) where the
    winner is a triangle — what K1's passes over the same candidates,
    chained through their keys, leave. Returns (zkey, fields)."""
    live = counts > 0
    rows = (ids - row0 * tiles_x).long()[live]
    if rows.numel() == 0:
        return zkey, fields
    dev = rec.device
    zk, f = raster_tiles_plain(
        rec, torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev), pair_tri,
        ids[live], starts[live], counts[live], zkey[rows], tiles_x, tile_h,
        tile_w, out_fields)
    hit = f[out_fields.index("idf")] >= 0.5
    zkey[rows] = zk
    fields[:, rows] = torch.where(hit, f, fields[:, rows])
    return zkey, fields


def raster_tiles_tail(rec, pair_tri, ids, starts, counts, zkey, fields,
                      tiles_x: int, tile_h: int, tile_w: int,
                      out_fields: tuple = _OUT_FIELDS, row0: int = 0):
    """K1's tail (csrc/raster.cu, ``raster_kernel`` in its TAIL mode); same
    contract as :func:`raster_tiles_tail_plain`, which it runs only for CPU
    tensors. One launch of one resident wave of blocks that take the
    slots' parts of CLUSTER_MIN_PART candidates, laid end to end by their
    prefix sums, in turn from a counter; counted in
    ``raster_tiles.launches`` (it is K1) and in its own ``launches``."""
    k = ids.shape[0]
    dev = rec.device
    npx = tile_h * tile_w
    _check("rec", rec, torch.float32, dev)
    if rec.ndim != 2 or rec.shape[1] != REC_CH:
        raise ValueError(f"rec: expected (T, {REC_CH}), got "
                         f"{tuple(rec.shape)}")
    _check("pair_tri", pair_tri, torch.int32, dev)
    for name, t in (("ids", ids), ("starts", starts), ("counts", counts)):
        _check(name, t, torch.int32, dev, (k,))
    _check("zkey", zkey, torch.int32, dev)
    if zkey.ndim != 2 or zkey.shape[1] != npx:
        raise ValueError(f"zkey: expected (NT, {npx}), got "
                         f"{tuple(zkey.shape)}")
    nt = zkey.shape[0]
    if fields.dtype != torch.float32 or fields.device != dev:
        raise ValueError("fields: expected float32 on the records' device")
    if tuple(fields.shape) != (len(out_fields), nt, npx) or (
            nt > 1 and fields.stride(1) != npx) or fields.stride(2) != 1:
        raise ValueError(f"fields: expected ({len(out_fields)}, {nt}, {npx})"
                         f" with contiguous rows, got {tuple(fields.shape)}")
    if "idf" not in out_fields:
        raise ValueError("raster_tiles_tail: out_fields must hold 'idf'")
    if dev.type == "cpu":
        return raster_tiles_tail_plain(rec, pair_tri, ids, starts, counts,
                                       zkey, fields, tiles_x, tile_h,
                                       tile_w, out_fields, row0)
    if dev.type != "cuda":
        raise RuntimeError(f"raster_tiles_tail: unsupported device {dev}")
    if npx > _build.MAX_TILE_PIXELS:
        raise ValueError(f"raster_tiles_tail: tiles of {npx} px exceed "
                         f"{_build.MAX_TILE_PIXELS}")
    if rec.data_ptr() % 16:
        raise ValueError("raster_tiles_tail: rec must be 16-byte aligned")
    mask = _field_mask(out_fields)
    if k == 0:
        return zkey, fields
    # The flat list of parts: each slot's part count, summed in order.
    ends = torch.cumsum(torch.div(counts + (CLUSTER_MIN_PART - 1),
                                  CLUSTER_MIN_PART, rounding_mode="floor"),
                        0, dtype=torch.int32)
    # The slots' packed (key, index) maxima, then their arrival counters
    # and the counter that hands out the parts.
    scratch = torch.zeros(k * npx + -(-(k + 1) // 2), dtype=torch.int64,
                          device=dev)
    counters = scratch.data_ptr() + k * npx * 8
    p = _build.ptr
    err = _build.library().bb_raster_tail(
        p(rec), p(pair_tri), pair_tri.shape[0], p(ids), p(starts),
        p(counts), p(ends), k, row0 * tiles_x, tiles_x, tile_h, tile_w,
        REC_CH, ctypes.c_uint(mask), p(scratch), ctypes.c_void_p(counters),
        ctypes.c_void_p(counters + 4 * k), p(zkey), p(fields),
        fields.stride(0), _build.stream_ptr(dev))
    _build.check(err, "raster_tail")
    raster_tiles.launches += 1
    raster_tiles_tail.launches += 1
    return zkey, fields


raster_tiles_tail.launches = 0


# ---------------------------------------------------------------------------
# K9: early-z raster + resolve
# ---------------------------------------------------------------------------

def raster_tiles_earlyz_plain(rec, big_ids, n_big, pair_tri, ids, starts,
                              counts, init_zkey, init_okey, zsh: int,
                              tiles_x: int, tile_h: int, tile_w: int,
                              out_fields: tuple = _OUT_FIELDS,
                              max_count: int | None = None):
    """Plain version of K9: :func:`raster_tiles_plain` with the winner the
    lexicographic argmax of (depth key, draw order) (``_scan_plain_ord``),
    continuing the keys ``init_zkey`` and the draw orders ``init_okey``
    ((K, NPX) float32, -1 = none). ``zsh`` is the kernel's bucket shift;
    the plain version scans every candidate. ``max_count``, the static
    cap on ``counts``, only sizes the kernel's launch
    (:func:`raster_cluster`). Returns (zkey, okey, fields)."""
    px, py = _pixel_centres(ids, tiles_x, tile_h, tile_w)
    best_key, best_ord, best = _scan_plain_ord(
        rec, big_ids, n_big, pair_tri, starts, counts, init_zkey, init_okey,
        px, py)
    return best_key, best_ord, _resolve_plain(rec, best, px, py, out_fields)


def raster_tiles_earlyz(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                        init_zkey, init_okey, zsh: int, tiles_x: int,
                        tile_h: int, tile_w: int,
                        out_fields: tuple = _OUT_FIELDS,
                        max_count: int | None = None,
                        cluster: int | None = None, stats=None):
    """K9 wrapper (csrc/raster_earlyz.cu); same contract as
    :func:`raster_tiles_earlyz_plain`, which it runs only for CPU tensors.
    The windows must be in :func:`bin_pairs`' ``zorder`` order for the
    kernel's break to be sound. A slot's candidates are split over a
    cluster of :func:`raster_cluster` blocks, as K1's; ``cluster``
    overrides the size (a measurement knob; any size gives the same
    result). ``stats``: an optional (2,) int64 CUDA tensor the kernel adds
    (8-row chunks of window rows scanned, summed over a slot's parts;
    8-row window chunks present) to."""
    k = _check_common(rec, big_ids, n_big, pair_tri, ids, starts, counts)
    npx = tile_h * tile_w
    _check("init_zkey", init_zkey, torch.int32, rec.device, (k, npx))
    _check("init_okey", init_okey, torch.float32, rec.device, (k, npx))
    if rec.device.type == "cpu":
        return raster_tiles_earlyz_plain(
            rec, big_ids, n_big, pair_tri, ids, starts, counts, init_zkey,
            init_okey, zsh, tiles_x, tile_h, tile_w, out_fields)
    if rec.device.type != "cuda":
        raise RuntimeError(f"raster_tiles_earlyz: unsupported device "
                           f"{rec.device}")
    if npx > _build.MAX_TILE_PIXELS:
        raise ValueError(f"raster_tiles_earlyz: tiles of {npx} px exceed "
                         f"{_build.MAX_TILE_PIXELS}")
    if cluster is None:
        cluster = raster_cluster(k, max_count)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"raster_tiles_earlyz: cluster {cluster} not in "
                         f"{CLUSTER_SIZES}")
    if rec.data_ptr() % 16:
        raise ValueError("raster_tiles_earlyz: rec must be 16-byte aligned")
    if stats is not None:
        _check("stats", stats, torch.int64, rec.device, (2,))
    mask = _field_mask(out_fields)
    zkey = torch.empty((k, npx), dtype=torch.int32, device=rec.device)
    okey = torch.empty((k, npx), dtype=torch.float32, device=rec.device)
    fields = torch.empty((len(out_fields), k, npx), dtype=torch.float32,
                         device=rec.device)
    if k == 0:
        return zkey, okey, fields
    p = _build.ptr
    err = _build.library().bb_raster_earlyz(
        p(rec), p(big_ids), p(n_big), big_ids.shape[0], p(pair_tri),
        pair_tri.shape[0], p(ids), p(starts), p(counts), p(init_zkey),
        p(init_okey), k, tiles_x, tile_h, tile_w, REC_CH,
        ctypes.c_uint(mask), int(zsh), cluster, p(zkey), p(okey), p(fields),
        p(stats) if stats is not None else None,
        _build.stream_ptr(rec.device))
    _build.check(err, "raster_earlyz")
    raster_tiles_earlyz.launches += 1
    return zkey, okey, fields


raster_tiles_earlyz.launches = 0


# ---------------------------------------------------------------------------
# K10: group-window raster + resolve
# ---------------------------------------------------------------------------

def raster_tiles_gw_plain(rec, big_ids, n_big, pair_tri, ids, win, lb_al,
                          cnt_k, init_zkey, group: int, tiles_x: int,
                          tile_h: int, tile_w: int,
                          out_fields: tuple = _OUT_FIELDS,
                          max_count: int | None = None):
    """Plain version of K10. Slots come in groups of ``group``; group g's
    window starts at ``pair_tri[win[g]]``, and slot s scans the overflow
    list, then window rows [lb_al[s], lb_al[s] + cnt_k[s]). Returns (zkey,
    fields) as :func:`raster_tiles_plain`. ``max_count``, the static cap
    on ``cnt_k``, only sizes the kernel's launch (:func:`raster_cluster`)."""
    starts = win.repeat_interleave(group) + lb_al
    return raster_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts,
                              cnt_k, init_zkey, tiles_x, tile_h, tile_w,
                              out_fields)


def raster_tiles_gw(rec, big_ids, n_big, pair_tri, ids, win, lb_al, cnt_k,
                    init_zkey, group: int, tiles_x: int, tile_h: int,
                    tile_w: int, out_fields: tuple = _OUT_FIELDS,
                    max_count: int | None = None,
                    cluster: int | None = None):
    """K10 wrapper (csrc/raster.cu ``raster_gw_kernel``: K1's scan, each
    slot's window start taken on the device as ``win[s // group] +
    lb_al[s]``); same contract as :func:`raster_tiles_gw_plain`, which it
    runs only for CPU tensors. A slot's candidates are split over a
    cluster of :func:`raster_cluster` blocks, as K1's; ``cluster``
    overrides the size (a measurement knob; any size gives the same
    result)."""
    k = _check_common(rec, big_ids, n_big, pair_tri, ids, lb_al, cnt_k)
    npx = tile_h * tile_w
    if group < 1 or k % group:
        raise ValueError(f"raster_tiles_gw: {k} slots in groups of {group}")
    _check("win", win, torch.int32, rec.device, (k // group,))
    _check("init_zkey", init_zkey, torch.int32, rec.device, (k, npx))
    if rec.device.type == "cpu":
        return raster_tiles_gw_plain(rec, big_ids, n_big, pair_tri, ids, win,
                                     lb_al, cnt_k, init_zkey, group, tiles_x,
                                     tile_h, tile_w, out_fields)
    if rec.device.type != "cuda":
        raise RuntimeError(f"raster_tiles_gw: unsupported device "
                           f"{rec.device}")
    if npx > _build.MAX_TILE_PIXELS:
        raise ValueError(f"raster_tiles_gw: tiles of {npx} px exceed "
                         f"{_build.MAX_TILE_PIXELS}")
    if cluster is None:
        cluster = raster_cluster(k, max_count)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"raster_tiles_gw: cluster {cluster} not in "
                         f"{CLUSTER_SIZES}")
    if rec.data_ptr() % 16:
        raise ValueError("raster_tiles_gw: rec must be 16-byte aligned")
    mask = _field_mask(out_fields)
    zkey = torch.empty((k, npx), dtype=torch.int32, device=rec.device)
    fields = torch.empty((len(out_fields), k, npx), dtype=torch.float32,
                         device=rec.device)
    if k == 0:
        return zkey, fields
    p = _build.ptr
    err = _build.library().bb_raster_gw(
        p(rec), p(big_ids), p(n_big), big_ids.shape[0], p(pair_tri),
        pair_tri.shape[0], p(ids), p(win), p(lb_al), p(cnt_k), p(init_zkey),
        k, group, tiles_x, tile_h, tile_w, REC_CH, ctypes.c_uint(mask),
        cluster, p(zkey), p(fields), _build.stream_ptr(rec.device))
    _build.check(err, "raster_gw")
    raster_tiles_gw.launches += 1
    return zkey, fields


raster_tiles_gw.launches = 0


# ---------------------------------------------------------------------------
# K11: fine-subtile raster + resolve
# ---------------------------------------------------------------------------

def _fine_order(t, k: int, tile_h: int, nsub: int, sub_w: int):
    """(K, NPX) screen order → (K·nsub, tile_h·sub_w) subtile-major."""
    return (t.reshape(k, tile_h, nsub, sub_w).permute(0, 2, 1, 3)
            .reshape(k * nsub, tile_h * sub_w))


def _screen_order(t, k: int, tile_h: int, nsub: int, sub_w: int):
    return (t.reshape(k, nsub, tile_h, sub_w).permute(0, 2, 1, 3)
            .reshape(k, tile_h * nsub * sub_w))


def raster_tiles_fine_plain(rec, big_ids, n_big, pair_tri, ids, starts,
                            lb_al, cntk, init_zkey, tiles_x: int,
                            tile_h: int, tile_w: int,
                            out_fields: tuple = _OUT_FIELDS):
    """Plain version of K11. Tile ``ids[s]`` splits into nsub =
    ``lb_al.shape[1]`` subtiles of (tile_w / nsub) × tile_h pixels;
    subtile g scans the overflow list, then
    ``pair_tri[starts[s] + lb_al[s, g]][:cntk[s, g]]`` against its own
    pixels. Returns (zkey, fields) in screen order, as
    :func:`raster_tiles_plain`."""
    k, nsub = lb_al.shape
    sub_w = tile_w // nsub
    px, py = _pixel_centres(ids, tiles_x, tile_h, tile_w)

    def fine(t):
        return _fine_order(t, k, tile_h, nsub, sub_w)

    best_key, best = _scan_plain(
        rec, big_ids, n_big, pair_tri, (starts[:, None] + lb_al).reshape(-1),
        cntk.reshape(-1), fine(init_zkey), fine(px), fine(py))
    best = _screen_order(best, k, tile_h, nsub, sub_w)
    return (_screen_order(best_key, k, tile_h, nsub, sub_w),
            _resolve_plain(rec, best, px, py, out_fields))


# K11 spreads each subtile's window over `parts` of the block's warps
# (csrc/raster_fine.cu): round j of subtile g goes to warp
# (g + j mod parts) mod nsub. All eight measured fastest on config 4's
# fine-bin frames on an H100 (PERF.md).
FINE_PARTS = (1, 2, 4, 8)
FINE_PARTS_DEFAULT = 8


def raster_tiles_fine(rec, big_ids, n_big, pair_tri, ids, starts, lb_al,
                      cntk, init_zkey, tiles_x: int, tile_h: int, tile_w: int,
                      out_fields: tuple = _OUT_FIELDS,
                      parts: int | None = None):
    """K11 wrapper (csrc/raster_fine.cu); same contract as
    :func:`raster_tiles_fine_plain`, which it runs only for CPU tensors.
    ``parts`` overrides the number of warps a subtile's window is spread
    over (a measurement knob; any number gives the same result)."""
    k = _check_common(rec, big_ids, n_big, pair_tri, ids, starts, starts)
    npx = tile_h * tile_w
    nsub = lb_al.shape[1] if lb_al.ndim == 2 else 0
    _check("lb_al", lb_al, torch.int32, rec.device, (k, nsub))
    _check("cntk", cntk, torch.int32, rec.device, (k, nsub))
    _check("init_zkey", init_zkey, torch.int32, rec.device, (k, npx))
    if nsub < 1 or tile_w % nsub:
        raise ValueError(f"raster_tiles_fine: {nsub} subtiles of a "
                         f"{tile_w}-px tile")
    if rec.device.type == "cpu":
        return raster_tiles_fine_plain(rec, big_ids, n_big, pair_tri, ids,
                                       starts, lb_al, cntk, init_zkey,
                                       tiles_x, tile_h, tile_w, out_fields)
    if rec.device.type != "cuda":
        raise RuntimeError(f"raster_tiles_fine: unsupported device "
                           f"{rec.device}")
    if parts is None:
        parts = FINE_PARTS_DEFAULT
    if parts not in FINE_PARTS:
        raise ValueError(f"raster_tiles_fine: parts {parts} not in "
                         f"{FINE_PARTS}")
    spx = tile_h * (tile_w // nsub)
    if nsub > NSUB_FINE or spx % 32 or spx // 32 > _build.MAX_TILE_PIXELS \
            // 256:
        raise ValueError(f"raster_tiles_fine: subtiles of {spx} px in "
                         f"{nsub} warps exceed the kernel's block")
    if rec.data_ptr() % 16:
        raise ValueError("raster_tiles_fine: rec must be 16-byte aligned")
    mask = _field_mask(out_fields)
    zkey = torch.empty((k, npx), dtype=torch.int32, device=rec.device)
    fields = torch.empty((len(out_fields), k, npx), dtype=torch.float32,
                         device=rec.device)
    if k == 0:
        return zkey, fields
    p = _build.ptr
    err = _build.library().bb_raster_fine(
        p(rec), p(big_ids), p(n_big), big_ids.shape[0], p(pair_tri),
        pair_tri.shape[0], p(ids), p(starts), p(lb_al), p(cntk),
        p(init_zkey), k, nsub, tiles_x, tile_h, tile_w, REC_CH,
        ctypes.c_uint(mask), parts, p(zkey), p(fields),
        _build.stream_ptr(rec.device))
    _build.check(err, "raster_fine")
    raster_tiles_fine.launches += 1
    return zkey, fields


raster_tiles_fine.launches = 0


# ---------------------------------------------------------------------------
# K4: overlay composite
# ---------------------------------------------------------------------------

def overlay_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                        n_live, zkey, ldr, tiles_x: int, tile_h: int,
                        tile_w: int, max_count: int | None = None):
    """Plain version of K4. Slots s < n_live rasterize tile ``ids[s]``
    (overflow list, then the window) against ``zkey[ids[s]]`` (``zkey``
    None: a cleared key, 0, at every pixel); where an overlay triangle
    wins, its interpolated flat colour replaces the LDR pixel. ``ldr`` is
    (3, NT, NPX); returns a new (3, NT, NPX) tensor. ``max_count`` only
    sizes the kernel's launch (:func:`overlay_cluster`)."""
    nt, npx = ldr.shape[1], tile_h * tile_w
    if zkey is None:
        zkey = torch.zeros((nt, npx), dtype=torch.int32, device=ldr.device)
    k = ids.shape[0]
    ids_l = ids.long()
    px, py = _pixel_centres(ids, tiles_x, tile_h, tile_w)
    _, best = _scan_plain(rec, big_ids, n_big, pair_tri, starts, counts,
                          zkey[ids_l], px, py)
    r = _winner_channels(rec, best)
    hit = r(_ID) >= 0.5
    e, inv = _bary(r, px, py)
    b = [e[j] * inv for j in range(3)]
    src = ldr[:, ids_l]
    out = torch.stack([
        torch.where(hit, r(_COL + 3 * c) * b[0] + r(_COL + 3 * c + 1) * b[1]
                    + r(_COL + 3 * c + 2) * b[2], src[c])
        for c in range(3)
    ])
    slot_live = torch.arange(k, device=ids.device) < n_live.reshape(())
    scatter = torch.where(slot_live, ids_l, torch.full_like(ids_l, nt))
    res = torch.cat([ldr, torch.zeros_like(ldr[:, :1])], dim=1)
    res[:, scatter] = out
    return res[:, :nt].contiguous()


# K4 runs K1's cluster split on a fixed grid (csrc/raster.cu
# overlay_kernel): OVERLAY_BLOCKS blocks — one wave of 4 blocks on each of
# an H100's 132 SMs — in clusters that deal the live slots among them, so
# neither the grid nor the host depends on how many slots are live. Its
# parts hold at least OVERLAY_MIN_PART candidates (the kernel's constant).
OVERLAY_BLOCKS = 4 * 132
OVERLAY_MIN_PART = 8


def overlay_cluster(max_count: int | None) -> int:
    """K4's cluster size for slots that scan at most ``max_count``
    candidates (the overflow list and a window, static capacities): the
    largest size that keeps every part at least OVERLAY_MIN_PART
    candidates long; 1 without a ``max_count``."""
    if max_count is None:
        return 1
    return max(c for c in CLUSTER_SIZES
               if c == 1 or max_count >= c * OVERLAY_MIN_PART)


def overlay_tiles(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                  n_live, zkey, ldr, tiles_x: int, tile_h: int, tile_w: int,
                  max_count: int | None = None, cluster: int | None = None,
                  clusters: int | None = None):
    """K4 wrapper (csrc/raster.cu ``overlay_kernel``): composites into
    ``ldr`` in place and returns it, with the result of
    :func:`overlay_tiles_plain` (which it runs for CPU tensors, copying
    the result into ``ldr``). ``ldr`` (3, NT, NPX) float32 may be a view
    whose planes are contiguous and apart (a channel stride of at least
    NT·NPX, such as the first NT tiles of a (3, NT + 1, NPX) buffer); only
    the pixels an overlay triangle wins are written. ``zkey`` (NT, NPX)
    int32, or None for a cleared key. ``n_live`` stays on the device: the
    kernel's clusters deal slots [0, n_live) among themselves. Launch
    knobs (any value gives the same result): ``cluster`` overrides
    :func:`overlay_cluster`, ``clusters`` the grid's cluster count
    (default: OVERLAY_BLOCKS / cluster, at most one per slot)."""
    k = _check_common(rec, big_ids, n_big, pair_tri, ids, starts, counts)
    dev = rec.device
    npx = tile_h * tile_w
    nt = ldr.shape[1] if ldr.ndim == 3 else -1
    _check("n_live", n_live, torch.int32, dev, (1,))
    if zkey is not None:
        _check("zkey", zkey, torch.int32, dev, (nt, npx))
    if (ldr.dtype != torch.float32 or ldr.device != dev
            or tuple(ldr.shape) != (3, nt, npx) or ldr.stride(2) != 1
            or ldr.stride(1) != npx or ldr.stride(0) < nt * npx):
        raise ValueError(f"ldr: expected (3, NT, {npx}) float32 planes on "
                         f"{dev} with contiguous, disjoint planes; got "
                         f"{tuple(ldr.shape)} {ldr.dtype} strides "
                         f"{ldr.stride()}")
    if dev.type == "cpu":
        ldr.copy_(overlay_tiles_plain(rec, big_ids, n_big, pair_tri, ids,
                                      starts, counts, n_live, zkey, ldr,
                                      tiles_x, tile_h, tile_w))
        return ldr
    if dev.type != "cuda":
        raise RuntimeError(f"overlay_tiles: unsupported device {dev}")
    if npx > _build.MAX_TILE_PIXELS:
        raise ValueError(f"overlay_tiles: tiles of {npx} px exceed "
                         f"{_build.MAX_TILE_PIXELS}")
    if cluster is None:
        cluster = overlay_cluster(max_count)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"overlay_tiles: cluster {cluster} not in "
                         f"{CLUSTER_SIZES}")
    if clusters is None:
        clusters = max(1, min(k, OVERLAY_BLOCKS // cluster))
    if clusters < 1:
        raise ValueError(f"overlay_tiles: clusters {clusters} < 1")
    if rec.data_ptr() % 16:
        raise ValueError("overlay_tiles: rec must be 16-byte aligned")
    if k == 0:
        return ldr
    p = _build.ptr
    err = _build.library().bb_overlay(
        p(rec), p(big_ids), p(n_big), big_ids.shape[0], p(pair_tri),
        pair_tri.shape[0], p(ids), p(starts), p(counts), p(n_live),
        None if zkey is None else p(zkey), p(ldr), ldr.stride(0), k,
        tiles_x, tile_h, tile_w, REC_CH, cluster, clusters,
        _build.stream_ptr(dev))
    _build.check(err, "overlay")
    overlay_tiles.launches += 1
    return ldr


overlay_tiles.launches = 0


# ---------------------------------------------------------------------------
# Host-side passes
# ---------------------------------------------------------------------------

def _overflow_rows(rec, big_ids):
    if rec.shape[0] == 0:
        return torch.zeros((big_ids.shape[0], REC_CH), dtype=torch.float32,
                           device=rec.device)
    rows = rec[torch.clamp(big_ids, min=0).long()]
    return rows * (big_ids >= 0).to(torch.float32)[:, None]


def _big_cover_mask(ov: torch.Tensor, big_ids: torch.Tensor, nt: int,
                    tiles_x: int, tile_h: int, tile_w: int,
                    row0: int = 0) -> torch.Tensor:
    """(NT,) conservative mask of tiles an overflow triangle may cover: an
    affine plane's max over a tile rectangle is at a corner. ``row0``:
    the frame tile row of tile 0 (a band's, in frame coordinates)."""
    dev = ov.device
    ar = torch.arange(nt, dtype=torch.int32, device=dev)
    tcol = (ar % tiles_x).to(torch.float32)
    trow = (ar // tiles_x + row0).to(torch.float32)
    x0 = (tcol * tile_w)[:, None]
    x1 = x0 + tile_w
    y0 = (trow * tile_h)[:, None]
    y1 = y0 + tile_h

    def plane_max(a, b, c):
        return (torch.maximum(x0 * a[None, :], x1 * a[None, :])
                + torch.maximum(y0 * b[None, :], y1 * b[None, :])
                + c[None, :])

    covers = (big_ids >= 0)[None, :].expand(nt, ov.shape[0])
    for e in range(3):
        covers = covers & (plane_max(ov[:, _A + e], ov[:, _B + e],
                                     ov[:, _C + e]) >= 0)
    covers = covers & (plane_max(ov[:, _ZC], ov[:, _ZC + 1],
                                 ov[:, _ZC + 2]) >= 0)
    covers = covers & (plane_max(ov[:, _WC], ov[:, _WC + 1],
                                 ov[:, _WC + 2]) > 0)
    covers = covers & (plane_max(ov[:, _WC] - ov[:, _ZC],
                                 ov[:, _WC + 1] - ov[:, _ZC + 1],
                                 ov[:, _WC + 2] - ov[:, _ZC + 2]) >= 0)
    return covers.any(dim=1)


def _compact_tile_list(live: torch.Tensor, k: int):
    """Compact a (NT,) mask to k ascending tile ids (live first; dead slots
    repeat the first id). Returns (ids (k,) int32, dropped count)."""
    nt = live.shape[0]
    iota = torch.arange(nt, dtype=torch.int32, device=live.device)
    neg = torch.where(live, -iota, torch.full_like(iota, -(1 << 30)))
    top = torch.topk(neg, k).values
    slot_live = top > -(1 << 30)
    ids = torch.where(slot_live, -top, torch.zeros_like(top))
    ids = torch.where(slot_live, ids, ids[0].expand_as(ids))
    dropped = torch.clamp(live.sum(dtype=torch.int32) - k, min=0)
    return ids.contiguous(), dropped


def _pixels_from_fields(f: dict) -> FusedPixels:
    zero = torch.zeros_like(f["idf"])
    f = {name: f.get(name, zero) for name in _OUT_FIELDS}
    hit = f["idf"] >= 0.5
    b0, b1 = f["b0"], f["b1"]
    return FusedPixels(
        tri_id=torch.round(f["idf"]).to(torch.int32) - 1,
        depth=f["depth"],
        bary=(b0, b1, torch.where(hit, 1.0 - b0 - b1, zero)),
        uv=(f["u"], f["v"]),
        normal=(f["nx"], f["ny"], f["nz"]),
        tangent=(f["tx"], f["ty"], f["tz"]),
        world=(f["wx"], f["wy"], f["wz"]),
        color=(f["cr"], f["cg"], f["cb"]),
        mat_id=torch.round(f["matf"]).to(torch.int32),
    )


def _ceil8(n: int) -> int:
    return -(-n // CHUNK) * CHUNK


def raster_fused(rec_table: torch.Tensor, setup: PlanarSetup, width: int,
                 height: int, tile_h: int = 8, tile_w: int = 128,
                 max_candidates: int = 320, overflow_cap: int = 64,
                 span_cap: int = 16, init_zkey: torch.Tensor | None = None,
                 pair_budget: int = 262144, passes: int = 1,
                 dense_tile_cap: int | None = None,
                 raster_tile_cap: int | None = None,
                 span_mid_cap: int | None = None,
                 group_pair_cap: int | None = None, drop_fields: tuple = (),
                 fine_bins: bool = False, earlyz: bool = False,
                 band_y0: int = 0, raster=raster_tiles,
                 raster_earlyz=raster_tiles_earlyz, raster_gw=raster_tiles_gw,
                 raster_fine=raster_tiles_fine, raster_tail=raster_tiles_tail,
                 sort=sort_keys):
    """Bin + rasterize + resolve: the host side of K1 and its schedule
    variants K9-K11 (port of ``raster_fused_pallas``, same contract).

    ``passes`` > 1: the reference's pass p covers candidate window
    [p·maxc, (p+1)·maxc), depth-chained through the previous pass's keys,
    on a compact list of the tiles denser than p·maxc (``dense_tile_cap``
    slots). Here passes 1..P-1 are K1's tail (``raster_tail``, one launch):
    one list of the tiles denser than maxc (``dense_tile_cap`` slots),
    each continuing its pass-0 keys over [maxc, maxc·passes) of its window
    and merging its winners into the planes in place — the chained
    passes' result, since each keeps the lexicographic max of (key,
    candidate position). What bounds the tail, and how its launch spreads
    the dense tiles' parts over the card: csrc/raster.cu. A tile the
    passes' lists would have dropped counts in ``diag.dropped_tiles`` as
    before; one left off the tail's list gets no tail.
    ``raster_tile_cap``: pass 0 runs only on tiles with candidates or
    conservative overflow-triangle cover. Both compactions are validated
    capacities (overflow → ``diag.dropped_tiles``). ``drop_fields`` prunes
    output planes (they come back as zeros).

    Schedule variants, gated exactly as the reference gates them:

    - ``group_pair_cap`` (K10, ``raster_gw``): with one pass and a pass-0
      ``raster_tile_cap``, and without ``fine_bins``, each group of compact
      slots reads one window of ``group_pair_cap`` rows; rows past it are
      dropped and counted in ``diag.dropped_cap``.
    - ``fine_bins`` (K11, ``raster_fine``): bins at (tile_w / 8)-px
      subtiles over the padded width; pass 0 scans each subtile's own fine
      window; the tail runs over the fine-ordered windows.
    - ``earlyz`` (K9, ``raster_earlyz``, every pass) unless ``fine_bins``
      or the group window is on, or the setup has no ``zub``: windows sort
      near-first and the winner carries its draw order across passes,
      which stay chained (no tail).

    The reference's ``merged_coverage`` (one coverage loop per group of
    tiles, slots sorted by chunk class) has no counterpart: a block here is
    one tile and loops to its own count, and the chunk-class slot order
    cost more in its sort than it saved in K1 (PERF.md, config 4).

    ``band_y0`` (a whole number of tiles): the pass covers the horizontal
    band of ``height`` rows that starts at this frame row, binned from a
    band setup (``ops.raster``) with the records in frame coordinates.
    The kernels read a slot's tile id only for its pixel centres, so they
    get the slots' frame tile ids and rasterize the band with the frame's
    own pixel centres: every pixel rounds as in the single frame.

    Returns (pixels: FusedPixels, zkey (NT, NPX) int32, diag: BinDiag)."""
    maxc = _ceil8(max_candidates)
    oc = _ceil8(overflow_cap)
    npx = tile_h * tile_w
    dev = rec_table.device
    row0 = band_y0 // tile_h
    nt_static = -(-width // tile_w) * -(-height // tile_h)
    use_gw = (group_pair_cap is not None and passes == 1
              and raster_tile_cap is not None
              and raster_tile_cap <= nt_static and not fine_bins)
    earlyz = (earlyz and not fine_bins and not use_gw
              and setup.zub is not None)
    if fine_bins:
        if tile_h != NSUB_FINE:
            raise ValueError(f"fine_bins requires tile_h == {NSUB_FINE} "
                             f"(got {tile_h})")
        nsub = NSUB_FINE
        # nsub consecutive fine bins per coarse tile over the padded width:
        # each coarse window stays one contiguous run of the pair list.
        tiles_x = -(-width // tile_w)
        (sorted_tri, starts_f, counts_f, big_ids, n_big, diag, tiles_y,
         _) = bin_pairs(setup, tiles_x * tile_w, height, tile_h,
                        tile_w // nsub, span_cap, oc, maxc * passes,
                        pair_budget=pair_budget, span_mid_cap=span_mid_cap,
                        sort=sort)
        nt = tiles_y * tiles_x
        starts_m = starts_f.reshape(nt, nsub)
        counts_m = counts_f.reshape(nt, nsub)
        starts = starts_m[:, 0].contiguous()
        counts_raw_c = counts_m.sum(dim=1, dtype=torch.int32)
        counts = torch.clamp(counts_raw_c, max=maxc * passes)
        diag = diag._replace(dropped_cap=diag.dropped_cap + torch.clamp(
            counts_raw_c - maxc * passes, min=0).sum(dtype=torch.int32))
        lb_raw = starts_m - starts[:, None]  # window-local subtile bases
    else:
        (sorted_tri, starts, counts, big_ids, n_big, diag, tiles_y,
         tiles_x) = bin_pairs(setup, width, height, tile_h, tile_w, span_cap,
                              oc, maxc * passes, pair_budget=pair_budget,
                              span_mid_cap=span_mid_cap, zorder=earlyz,
                              sort=sort)
        nt = tiles_y * tiles_x
    gcap = _ceil8(group_pair_cap) if use_gw else 0
    if init_zkey is None:
        init_zkey = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    if dense_tile_cap is None:
        dense_tile_cap = min(nt, max(64, nt // 4))
    out_fields = tuple(f for f in _OUT_FIELDS
                       if f not in drop_fields or f == "idf")
    zero1 = torch.zeros((1,), dtype=torch.int32, device=dev)
    zsh = 0
    okey = None
    if earlyz:
        zb = zorder_bits(nt, int(setup.valid.shape[0]))
        zsh = 30 - (zb if zb > 0 else 16)
        # Winner draw-order chain: -1 = clear (any candidate tying the
        # initial key wins, as with K1's >=).
        okey = torch.full((nt, npx), -1.0, dtype=torch.float32, device=dev)

    zkey = init_zkey
    planes = None  # (len(out_fields), NT, NPX), rows contiguous
    idf = out_fields.index("idf")
    dropped_tiles = torch.zeros((), dtype=torch.int32, device=dev)
    dropped_win = torch.zeros((), dtype=torch.int32, device=dev)
    # Pass 0; K9's passes ≥ 1 too, which chain the draw order.
    for p in range(passes if earlyz else 1):
        nb_p = n_big if p == 0 else zero1
        scatter_ids = None
        if p == 0 and raster_tile_cap is not None and raster_tile_cap <= nt:
            live0 = (counts > 0) | _big_cover_mask(
                _overflow_rows(rec_table, big_ids), big_ids, nt, tiles_x,
                tile_h, tile_w, row0)
            k = raster_tile_cap
            ids, dropped0 = _compact_tile_list(live0, k)
            dropped_tiles = dropped_tiles + dropped0
            n_live = torch.clamp(live0.sum(dtype=torch.int32), max=k)
            slot_live = torch.arange(k, device=dev) < n_live
            scatter_ids = torch.where(slot_live, ids.long(),
                                      torch.full_like(ids.long(), nt))
            starts_p = starts[ids.long()]
            counts_p = torch.where(slot_live,
                                   torch.clamp(counts[ids.long()], max=maxc),
                                   torch.zeros_like(ids))
        elif p == 0:
            k = nt
            ids = torch.arange(nt, dtype=torch.int32, device=dev)
            starts_p = starts
            counts_p = torch.clamp(counts, max=maxc)
        else:
            live = counts > p * maxc
            k = min(dense_tile_cap, nt)  # a larger list holds only dead slots
            ids, dropped_p = _compact_tile_list(live, k)
            dropped_tiles = dropped_tiles + dropped_p
            n_live_p = torch.clamp(live.sum(dtype=torch.int32), max=k)
            slot_live_p = torch.arange(k, device=dev) < n_live_p
            starts_p = starts[ids.long()] + p * maxc
            counts_p = torch.where(
                slot_live_p,
                torch.clamp(counts[ids.long()] - p * maxc, 0, maxc),
                torch.zeros_like(ids))
        ids = ids.contiguous()
        frame_ids = ids + row0 * tiles_x if row0 else ids
        zk_in = zkey[ids.long()].contiguous()
        ok_new = None
        if p == 0 and fine_bins:
            # Per-slot subtile bases and counts into the coarse window;
            # bases align down to CHUNK (the retested prefix rows lose
            # their duplicate ties exactly).
            lbp = lb_raw[ids.long()]
            cfp = counts_m[ids.long()]
            kept = torch.minimum(torch.clamp(maxc - lbp, min=0), cfp)
            lb_al = (lbp // CHUNK) * CHUNK
            cntk = torch.where(kept > 0, kept + (lbp - lb_al),
                               torch.zeros_like(kept))
            if scatter_ids is not None:
                cntk = cntk * slot_live[:, None].to(torch.int32)
            zk_new, fouts = raster_fine(
                rec_table, big_ids, nb_p, sorted_tri, frame_ids,
                starts_p.contiguous(), lb_al.contiguous(), cntk.contiguous(),
                zk_in, tiles_x, tile_h, tile_w, out_fields)
        elif p == 0 and use_gw:
            # One window of gcap rows per group of compact slots; per-slot
            # bases 8-aligned downward. The group size (the reference's
            # VMEM bound) decides the windows, so it is kept as is.
            gmax = max(1, (32 << 20) // ((oc + gcap) * npx * 2))
            group = next(g for g in (8, 4, 2, 1) if g <= gmax and k % g == 0)
            win = starts_p.reshape(k // group, group)[:, 0].contiguous()
            lb = torch.clamp(starts_p - win.repeat_interleave(group), 0,
                             gcap)
            kept = torch.minimum(torch.clamp(gcap - lb, min=0), counts_p)
            dropped_win = dropped_win + (counts_p - kept).sum(
                dtype=torch.int32)
            lb_al = (lb // CHUNK) * CHUNK
            cnt_k = kept + (lb - lb_al)
            zk_new, fouts = raster_gw(
                rec_table, big_ids, nb_p, sorted_tri, frame_ids, win,
                lb_al.contiguous(), cnt_k.contiguous(), zk_in, group,
                tiles_x, tile_h, tile_w, out_fields,
                max_count=gcap + CHUNK - 1)
        elif earlyz:
            zk_new, ok_new, fouts = raster_earlyz(
                rec_table, big_ids, nb_p, sorted_tri, frame_ids,
                starts_p.contiguous(), counts_p.contiguous(), zk_in,
                okey[ids.long()].contiguous(), zsh, tiles_x, tile_h, tile_w,
                out_fields, max_count=maxc)
        else:
            zk_new, fouts = raster(
                rec_table, big_ids, nb_p, sorted_tri, frame_ids,
                starts_p.contiguous(), counts_p.contiguous(), zk_in, tiles_x,
                tile_h, tile_w, out_fields, max_count=maxc)
        if p == 0 and scatter_ids is not None:
            # Unlisted tiles keep clear/init depth and zero fields; dead
            # slots drop their writes (scatter target nt).
            zk = torch.cat([zkey & LOW3, zk_new[:1]])
            zk[scatter_ids] = zk_new
            zkey = zk[:nt]
            if ok_new is not None:
                ok = torch.cat([okey, ok_new[:1]])
                ok[scatter_ids] = ok_new
                okey = ok[:nt]
            full = torch.zeros((len(out_fields), nt + 1, npx),
                               dtype=torch.float32, device=dev)
            full[:, scatter_ids] = fouts
            planes = full[:, :nt]
        elif p == 0:
            zkey, planes = zk_new, fouts
            if ok_new is not None:
                okey = ok_new
        else:
            ids_sc = torch.where(slot_live_p, ids.long(),
                                 torch.full_like(ids.long(), nt))
            zk = torch.cat([zkey, zk_new[:1]])
            zk[ids_sc] = zk_new
            zkey = zk[:nt]
            ok = torch.cat([okey, ok_new[:1]])
            ok[ids_sc] = ok_new
            okey = ok[:nt]
            full = torch.cat([planes, planes[:, :1]], dim=1)
            full[:, ids_sc] = torch.where(fouts[idf] >= 0.5, fouts,
                                          planes[:, ids.long()])
            planes = full[:, :nt]
    if passes > 1 and not earlyz:
        # Passes 1..P-1 as K1's tail: one list of the tiles denser than a
        # window (every later pass's tiles), each scanning the rest of its
        # window [maxc, min(count, maxc·passes)) from its pass-0 keys and
        # merging its winners into the planes in place. dropped_tiles
        # counts what the passes' own lists would have dropped.
        k = min(dense_tile_cap, nt)  # a larger list holds only dead slots
        ids, _ = _compact_tile_list(counts > maxc, k)
        dense = (counts[None, :] > maxc * torch.arange(
            1, passes, dtype=torch.int32, device=dev)[:, None]).sum(
                dim=1, dtype=torch.int32)
        dropped_tiles = dropped_tiles + torch.clamp(dense - k, min=0).sum(
            dtype=torch.int32)
        slot_live = torch.arange(k, device=dev) < torch.clamp(dense[0],
                                                              max=k)
        tail = maxc * (passes - 1)
        counts_t = torch.where(
            slot_live, torch.clamp(counts[ids.long()] - maxc, 0, tail),
            torch.zeros_like(ids))
        raster_tail(rec_table, sorted_tri,
                    ids + row0 * tiles_x if row0 else ids,
                    (starts[ids.long()] + maxc).contiguous(),
                    counts_t.contiguous(), zkey, planes, tiles_x, tile_h,
                    tile_w, out_fields, row0=row0)
        profiling.count("raster_tail")
    diag = diag._replace(dropped_cap=diag.dropped_cap + dropped_win,
                         dropped_tiles=diag.dropped_tiles + dropped_tiles)
    return (_pixels_from_fields(dict(zip(out_fields, planes))),
            zkey.contiguous(), diag)


def composite_overlay(rec_table: torch.Tensor, setup: PlanarSetup,
                      ldr: torch.Tensor, zkey: torch.Tensor | None,
                      width: int, height: int, tile_h: int = 8,
                      tile_w: int = 128, max_candidates: int = 128,
                      overflow_cap: int = 64, span_cap: int = 64,
                      max_tiles: int = 512, pair_budget: int = 65536,
                      span_mid_cap: int | None = None,
                      overlay=overlay_tiles, sort=sort_keys):
    """Composite depth-tested flat-colour geometry into the LDR planes
    ``ldr`` ((3, NT, NPX), :func:`overlay_tiles`' layout) over a compact
    list of the tiles it may touch (the host side of K4), continuing the
    scene's keys ``zkey`` (None: a cleared key).

    Returns (ldr', diag): ``overlay``'s result — the kernel wrapper writes
    ``ldr`` in place and returns it, the plain version a new tensor — and
    the binning's BinDiag; tiles beyond ``max_tiles`` land in
    diag.dropped_tiles."""
    maxc = _ceil8(max_candidates)
    oc = _ceil8(overflow_cap)
    dev = rec_table.device
    (sorted_tri, starts, counts, big_ids, n_big, diag, tiles_y,
     tiles_x) = bin_pairs(setup, width, height, tile_h, tile_w, span_cap, oc,
                          maxc, pair_budget=pair_budget,
                          span_mid_cap=span_mid_cap, sort=sort)
    nt = tiles_y * tiles_x
    live = (counts > 0) | _big_cover_mask(
        _overflow_rows(rec_table, big_ids), big_ids, nt, tiles_x, tile_h,
        tile_w)
    k_top = min(max_tiles, nt)
    ids, dropped = _compact_tile_list(live, k_top)
    diag = diag._replace(dropped_tiles=dropped)
    n_live = torch.clamp(live.sum(dtype=torch.int32), max=k_top).reshape(1)
    slot_live = torch.arange(k_top, device=dev) < n_live
    counts_c = torch.where(slot_live, counts[ids.long()],
                           torch.zeros_like(ids))
    out = overlay(rec_table, big_ids, n_big, sorted_tri, ids,
                  starts[ids.long()].contiguous(), counts_c.contiguous(),
                  n_live.contiguous(), zkey, ldr, tiles_x, tile_h, tile_w,
                  max_count=oc + maxc)
    return out, diag


def untile(plane: torch.Tensor, width: int, height: int, tiles_x: int,
           tile_h: int, tile_w: int) -> torch.Tensor:
    """(NT, NPX) tiled-planar → (H, W) image."""
    nt = plane.shape[0]
    tiles_y = nt // tiles_x
    img = (plane.reshape(tiles_y, tiles_x, tile_h, tile_w)
           .permute(0, 2, 1, 3)
           .reshape(tiles_y * tile_h, tiles_x * tile_w))
    return img[:height, :width]


def tile_plane(img: torch.Tensor, tiles_x: int, tiles_y: int, tile_h: int,
               tile_w: int, fill=0.0) -> torch.Tensor:
    """(H, W) image → (NT, NPX) tiled-planar, padded to whole tiles with
    ``fill``."""
    h, w = img.shape
    img = torch.nn.functional.pad(
        img, (0, tiles_x * tile_w - w, 0, tiles_y * tile_h - h), value=fill)
    return (img.reshape(tiles_y, tile_h, tiles_x, tile_w)
            .permute(0, 2, 1, 3)
            .reshape(tiles_y * tiles_x, tile_h * tile_w).contiguous())
