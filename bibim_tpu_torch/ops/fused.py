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
from bibim_tpu_torch.ops.sort import sort_keys, sort_pairs

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
                       tangent, world, color, mat_id=None) -> torch.Tensor:
    """Records for an indexed mesh: attributes are (V, k) vertex arrays
    gathered per corner by ``tris`` (T, 3)."""
    v = uv.shape[0]
    dev = uv.device
    if mat_id is None:
        mat_id = torch.zeros((v,), dtype=torch.int32, device=dev)
    vert = torch.cat([uv, normal, tangent, world, color,
                      mat_id.to(torch.float32)[:, None]], dim=1)  # (V, 15)
    va = vert[tris.long()]  # (T, 3, 15)
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
              span_mid_cap: int | None = None, sort=sort_keys):
    """Sort-based sparse binning → per-tile [start, count) windows.

    Each triangle expands its bbox tiles into (tile, tri) pair slots; the
    sorted pair list groups pairs per tile in draw order. Triangles spanning
    more than ``span_cap`` tiles go to the overflow list (``big_ids``).
    ``span_mid_cap`` enables span-class binning: every triangle expands only
    SPAN_DENSE slots, and the few spanning (SPAN_DENSE, span_cap] tiles go
    through a compacted list of that capacity — same sorted pair set, a
    smaller sort.

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
        total_mid = torch.where(mid, area, torch.zeros_like(area)).sum(
            dtype=i32)
        dropped_mid = total_mid - area_m.sum(dtype=i32)
    else:
        tile = torch.stack([slot_tile(k, small & (k < area))
                            for k in range(span_cap)])
        flat_tile = tile.reshape(-1)
        tri_of_pair = iota[None, :].expand(span_cap, t).reshape(-1)
        neg = torch.where(big, -iota, torch.full_like(iota, neg_fill))
        k_top = min(overflow_cap, t)
        top = torch.topk(neg, k_top).values
        big_ids = torch.where(top > neg_fill, -top, torch.full_like(top, -1))
        if k_top < overflow_cap:
            big_ids = torch.cat([big_ids, torch.full(
                (overflow_cap - k_top,), -1, dtype=i32, device=dev)])
        n_big = torch.clamp(n_big_all, max=overflow_cap)

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


def _scan_plain(rec, big_ids, n_big, pair_tri, starts, counts, init_key,
                px, py):
    """Coverage + depth scan of every slot's candidate sequence (overflow
    list, then the window) in CHUNK-row steps: within a chunk the highest
    ``(masked key) | row`` wins (later row on ties), across chunks the
    running key is replaced on ``>=`` — the reference kernel's rule.
    Returns (best_key, best_tri) (K, NPX) int32; best_tri -1 = no winner."""
    k_slots, npx = init_key.shape
    dev = rec.device
    best_key = init_key & LOW3
    best = torch.full((k_slots, npx), -1, dtype=torch.int32, device=dev)
    if k_slots == 0 or rec.shape[0] == 0:
        return best_key, best
    nb = n_big.reshape(()).to(torch.int64)
    total = nb + counts.to(torch.int64)
    n_iter = int(total.max())
    oc = max(big_ids.shape[0], 1)
    p_len = max(pair_tri.shape[0], 1)
    big_src = big_ids if big_ids.shape[0] else torch.full(
        (1,), -1, dtype=torch.int32, device=dev)
    pair_src = pair_tri if pair_tri.shape[0] else torch.zeros(
        (1,), dtype=torch.int32, device=dev)
    row_ix = torch.arange(CHUNK, dtype=torch.int32, device=dev)
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
        co = rec[torch.clamp(tri, min=0).long(), :15]  # (K, CHUNK, 15)
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
        z = torch.where(ok, z, torch.full_like(z, -1.0))
        key = (z.view(torch.int32) & LOW3) | row_ix[None, :, None]
        kmax = key.max(dim=1).values  # (K, NPX)
        kz = kmax & LOW3
        accept = kz >= best_key
        win_tri = torch.gather(tri, 1, (kmax & 7).long())
        best = torch.where(accept, win_tri, best)
        best_key = torch.where(accept, kz, best_key)
    return best_key, best


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

def raster_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                       init_zkey, tiles_x: int, tile_h: int, tile_w: int,
                       out_fields: tuple = _OUT_FIELDS):
    """Plain version of K1. Slot s rasterizes screen tile ``ids[s]`` from
    the overflow list (``big_ids[:n_big]``) and then
    ``pair_tri[starts[s] : starts[s] + counts[s]]``, continuing the
    depth keys ``init_zkey[s]``. Returns (zkey (K, NPX) int32, fields
    (len(out_fields), K, NPX) float32)."""
    px, py = _pixel_centres(ids, tiles_x, tile_h, tile_w)
    best_key, best = _scan_plain(rec, big_ids, n_big, pair_tri, starts,
                                 counts, init_zkey, px, py)
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
        fields = torch.stack([vals[f]() for f in out_fields])
    else:
        fields = torch.zeros((0,) + idf.shape, dtype=torch.float32,
                             device=idf.device)
    return best_key, fields


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


def raster_tiles(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                 init_zkey, tiles_x: int, tile_h: int, tile_w: int,
                 out_fields: tuple = _OUT_FIELDS):
    """K1 wrapper (csrc/raster.cu); same contract as
    :func:`raster_tiles_plain`, which it runs only for CPU tensors."""
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
        k, tiles_x, tile_h, tile_w, REC_CH, ctypes.c_uint(mask),
        p(zkey), p(fields), _build.stream_ptr(rec.device))
    _build.check(err, "raster")
    raster_tiles.launches += 1
    return zkey, fields


raster_tiles.launches = 0


# ---------------------------------------------------------------------------
# K4: overlay composite
# ---------------------------------------------------------------------------

def overlay_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                        n_live, zkey, ldr, tiles_x: int, tile_h: int,
                        tile_w: int):
    """Plain version of K4. Slots s < n_live rasterize tile ``ids[s]``
    (overflow list, then the window) against ``zkey[ids[s]]``; where an
    overlay triangle wins, its interpolated flat colour replaces the LDR
    pixel. ``ldr`` is (3, NT, NPX); returns a new (3, NT, NPX) tensor."""
    nt = ldr.shape[1]
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


def overlay_tiles(rec, big_ids, n_big, pair_tri, ids, starts, counts,
                  n_live, zkey, ldr, tiles_x: int, tile_h: int, tile_w: int):
    """K4 wrapper (csrc/overlay.cu); same contract as
    :func:`overlay_tiles_plain`, which it runs only for CPU tensors. Dead
    slots (s >= n_live) are skipped by the kernel."""
    k = _check_common(rec, big_ids, n_big, pair_tri, ids, starts, counts)
    dev = rec.device
    npx = tile_h * tile_w
    nt = zkey.shape[0]
    _check("n_live", n_live, torch.int32, dev, (1,))
    _check("zkey", zkey, torch.int32, dev, (nt, npx))
    _check("ldr", ldr, torch.float32, dev, (3, nt, npx))
    if dev.type == "cpu":
        return overlay_tiles_plain(rec, big_ids, n_big, pair_tri, ids, starts,
                                   counts, n_live, zkey, ldr, tiles_x,
                                   tile_h, tile_w)
    if dev.type != "cuda":
        raise RuntimeError(f"overlay_tiles: unsupported device {dev}")
    if npx > _build.MAX_TILE_PIXELS:
        raise ValueError(f"overlay_tiles: tiles of {npx} px exceed "
                         f"{_build.MAX_TILE_PIXELS}")
    out = ldr.clone()
    if k == 0:
        return out
    p = _build.ptr
    err = _build.library().bb_overlay(
        p(rec), p(big_ids), p(n_big), big_ids.shape[0], p(pair_tri),
        pair_tri.shape[0], p(ids), p(starts), p(counts), p(n_live), p(zkey),
        p(out), k, nt, tiles_x, tile_h, tile_w, REC_CH,
        _build.stream_ptr(dev))
    _build.check(err, "overlay")
    overlay_tiles.launches += 1
    return out


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
                    tiles_x: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """(NT,) conservative mask of tiles an overflow triangle may cover: an
    affine plane's max over a tile rectangle is at a corner."""
    dev = ov.device
    ar = torch.arange(nt, dtype=torch.int32, device=dev)
    tcol = (ar % tiles_x).to(torch.float32)
    trow = (ar // tiles_x).to(torch.float32)
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
                 span_mid_cap: int | None = None, drop_fields: tuple = (),
                 raster=raster_tiles, sort=sort_keys):
    """Bin + rasterize + resolve (the host side of K1; port of
    ``raster_fused_pallas`` without its TPU schedule variants).

    ``passes`` > 1: pass p covers candidate window [p·maxc, (p+1)·maxc),
    depth-chained through the previous pass's keys, on a compact list of
    the tiles denser than p·maxc (``dense_tile_cap`` slots).
    ``raster_tile_cap``: pass 0 runs only on tiles with candidates or
    conservative overflow-triangle cover. Both compactions are validated
    capacities (overflow → ``diag.dropped_tiles``). ``drop_fields`` prunes
    output planes (they come back as zeros).

    Returns (pixels: FusedPixels, zkey (NT, NPX) int32, diag: BinDiag)."""
    maxc = _ceil8(max_candidates)
    oc = _ceil8(overflow_cap)
    npx = tile_h * tile_w
    dev = rec_table.device
    (sorted_tri, starts, counts, big_ids, n_big, diag, tiles_y,
     tiles_x) = bin_pairs(setup, width, height, tile_h, tile_w, span_cap, oc,
                          maxc * passes, pair_budget=pair_budget,
                          span_mid_cap=span_mid_cap, sort=sort)
    nt = tiles_y * tiles_x
    if init_zkey is None:
        init_zkey = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    if dense_tile_cap is None:
        dense_tile_cap = min(nt, max(64, nt // 4))
    out_fields = tuple(f for f in _OUT_FIELDS
                       if f not in drop_fields or f == "idf")
    zero1 = torch.zeros((1,), dtype=torch.int32, device=dev)

    zkey = init_zkey
    fields = None
    dropped_tiles = torch.zeros((), dtype=torch.int32, device=dev)
    for p in range(passes):
        nb_p = n_big if p == 0 else zero1
        scatter_ids = None
        if p == 0 and raster_tile_cap is not None and raster_tile_cap <= nt:
            live0 = (counts > 0) | _big_cover_mask(
                _overflow_rows(rec_table, big_ids), big_ids, nt, tiles_x,
                tile_h, tile_w)
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
            k = dense_tile_cap
            ids, dropped_p = _compact_tile_list(live, k)
            dropped_tiles = dropped_tiles + dropped_p
            n_live_p = torch.clamp(live.sum(dtype=torch.int32), max=k)
            slot_live_p = torch.arange(k, device=dev) < n_live_p
            starts_p = starts[ids.long()] + p * maxc
            counts_p = torch.where(
                slot_live_p,
                torch.clamp(counts[ids.long()] - p * maxc, 0, maxc),
                torch.zeros_like(ids))
        zk_in = zkey[ids.long()].contiguous()
        zk_new, fouts = raster(
            rec_table, big_ids, nb_p, sorted_tri, ids.contiguous(),
            starts_p.contiguous(), counts_p.contiguous(), zk_in, tiles_x,
            tile_h, tile_w, out_fields)
        fields_p = dict(zip(out_fields, fouts))
        if p == 0 and scatter_ids is not None:
            zk = torch.cat([zkey & LOW3, zk_new[:1]])
            zk[scatter_ids] = zk_new
            zkey = zk[:nt]
            fields = {}
            for f, v in fields_p.items():
                full = torch.zeros((nt + 1, npx), dtype=torch.float32,
                                   device=dev)
                full[scatter_ids] = v
                fields[f] = full[:nt]
        elif p == 0:
            zkey, fields = zk_new, fields_p
        else:
            ids_sc = torch.where(slot_live_p, ids.long(),
                                 torch.full_like(ids.long(), nt))
            hit = fields_p["idf"] >= 0.5
            zk = torch.cat([zkey, zk_new[:1]])
            zk[ids_sc] = zk_new
            zkey = zk[:nt]
            new_fields = {}
            for f in fields:
                full = torch.cat([fields[f], fields[f][:1]])
                full[ids_sc] = torch.where(hit, fields_p[f],
                                           fields[f][ids.long()])
                new_fields[f] = full[:nt]
            fields = new_fields
    diag = diag._replace(dropped_tiles=diag.dropped_tiles + dropped_tiles)
    return _pixels_from_fields(fields), zkey.contiguous(), diag


def composite_overlay(rec_table: torch.Tensor, setup: PlanarSetup,
                      ldr3: tuple, zkey: torch.Tensor, width: int,
                      height: int, tile_h: int = 8, tile_w: int = 128,
                      max_candidates: int = 128, overflow_cap: int = 64,
                      span_cap: int = 64, max_tiles: int = 512,
                      pair_budget: int = 65536,
                      span_mid_cap: int | None = None,
                      overlay=overlay_tiles, sort=sort_keys):
    """Composite depth-tested flat-colour geometry into LDR planes over a
    compact list of the tiles it may touch (the host side of K4).

    Returns (ldr3', diag); tiles beyond ``max_tiles`` land in
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
    ldr = torch.stack(ldr3).contiguous()
    out = overlay(rec_table, big_ids, n_big, sorted_tri, ids,
                  starts[ids.long()].contiguous(), counts_c.contiguous(),
                  n_live.contiguous(), zkey.contiguous(), ldr, tiles_x,
                  tile_h, tile_w)
    return (out[0], out[1], out[2]), diag


def untile(plane: torch.Tensor, width: int, height: int, tiles_x: int,
           tile_h: int, tile_w: int) -> torch.Tensor:
    """(NT, NPX) tiled-planar → (H, W) image."""
    nt = plane.shape[0]
    tiles_y = nt // tiles_x
    img = (plane.reshape(tiles_y, tiles_x, tile_h, tile_w)
           .permute(0, 2, 1, 3)
           .reshape(tiles_y * tile_h, tiles_x * tile_w))
    return img[:height, :width]
