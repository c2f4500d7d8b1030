"""Material tables and their plain samplers (port of
``bibim_tpu.ops.texture_quad``, per-pixel and pair-rate sampling).

All maps of one resolution pack into one table ("size group"):

- :class:`QuadTable`: one u8 row per texel holding its 2×2 wrap-correct
  neighbourhood, [t00 | t01 | t10 | t11] × cpad channels;
- :class:`BlockTable`: for big groups, one u8 row per BLOCK_B×BLOCK_B texel
  block holding its (B+1)² wrap-correct neighbourhood, taps (j, i)
  row-major × cpad channels, padded to a 128-byte multiple.

Sampling is bilinear with REPEAT addressing, texel centres at +0.5 and u8
× 1/255 dequantization. The sampled-shade kernel (``ops.shading``, K2)
reads these rows by index. The standalone samplers here are two kernels
and their plain versions:

- K6, :func:`sample_table_block_kernel` (csrc/sample.cu, replaces
  ``sample_table_block_pallas``, per pixel and at pair rate); plain
  version :func:`sample_table_block`. At pair rate (pair_sampling 1 / 2)
  each 2×1 / 2×2 pixel group reads one block row, anchored at
  :func:`pair_window`; :func:`escape_tiles` flags the tiles where that is
  not bit-exact;
- K7, :func:`sample_rows_small` / :func:`sample_table_small`
  (csrc/sample.cu, replaces ``sample_rows_small_pallas`` /
  ``sample_table_small_pallas``); plain versions
  :func:`sample_rows_small_plain` / :func:`sample_table_small_plain`, in
  the kernel's ``_blend`` order (top/bottom rows first);

and :func:`sample_table_xla`, the JAX package's XLA sampler (w00..w11
order), which the debug ("full") frame and big quad tables use.
:func:`sample_material` dispatches between them as the JAX package does.

Trilinear mips (BASELINE config 2):

- :class:`MipQuadTable` / :class:`MipQuadMulti`: quad rows of every level
  (paired: each row also carries its parent level's 3×3 block), one or
  several materials merged flat; the oracle samplers
  :func:`sample_mip_table` / :func:`sample_mip_multi`;
- :class:`MipBlockMulti`: one row per 4×4 block of each level holding the
  5×5 child and the covering 4×4 parent neighbourhood, so a trilinear
  sample reads ONE row. :func:`_mip_block_geometry` computes the LOD from
  2×2 pixel-quad uv differences, the level / material select and every
  footprint plane as torch ops, for K2's mip-block group and both plain
  versions;
- K8, :func:`sample_mip_block_kernel` (csrc/mip_sample.cu, replaces
  ``sample_mip_block_pallas``): the same geometry in the kernel, from
  :func:`mip_level_table`; plain version :func:`sample_mip_block`;
- :func:`sample_material_mips_multi` routes as the JAX package does:
  block groups → K8, single-level small groups → K7 with a material-routed
  row index, anything else → the quad oracle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bibim_tpu_torch import _build

SLOTS = (
    "alb_r", "alb_g", "alb_b",
    "nrm_x", "nrm_y", "nrm_z",
    "metallic", "roughness", "ao", "height",
)
BLOCK_B = 4
# Quad tables with at most this many texel rows sample through K7 (the
# JAX package's MXU one-hot bound, kept as the dispatch rule).
SMALL_ROWS = 2048
_INV255 = 1.0 / 255.0


class QuadTable(NamedTuple):
    quads: torch.Tensor  # (H*W, 4*cpad) uint8
    height: int
    width: int
    present: tuple  # slot names in channel order


class BlockTable(NamedTuple):
    blocks: torch.Tensor  # (H*W/B², row_bytes) uint8
    height: int
    width: int
    present: tuple


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def build_quad_tables(maps: dict, block_threshold: int | None = None,
                      device="cuda") -> tuple:
    """Group slot → (H, W[, ≥1]) uint8 maps by resolution into tables;
    groups above ``block_threshold`` texels (and B-divisible) become
    :class:`BlockTable`. Runs on the host once per material bind."""
    groups: dict = {}
    for slot, img in maps.items():
        groups.setdefault((int(img.shape[0]), int(img.shape[1])),
                          {})[slot] = img
    tables = []
    for (h, w), slot_imgs in sorted(groups.items()):
        present = tuple(sorted(slot_imgs, key=SLOTS.index))
        cpad = _ceil4(len(present))
        tex = np.zeros((h, w, cpad), np.uint8)
        for k, slot in enumerate(present):
            img = slot_imgs[slot]
            tex[:, :, k] = img[:, :, 0] if img.ndim == 3 else img
        if (block_threshold is not None and h * w > block_threshold
                and h % BLOCK_B == 0 and w % BLOCK_B == 0):
            tables.append(_build_block_table(tex, h, w, present, cpad,
                                             device))
            continue
        t01 = np.roll(tex, -1, axis=1)
        t10 = np.roll(tex, -1, axis=0)
        t11 = np.roll(t01, -1, axis=0)
        quads = np.concatenate([tex, t01, t10, t11], axis=-1).reshape(
            h * w, 4 * cpad)
        tables.append(QuadTable(
            quads=torch.as_tensor(np.ascontiguousarray(quads), device=device),
            height=h, width=w, present=present))
    return tuple(tables)


def _build_block_table(tex: np.ndarray, h: int, w: int, present: tuple,
                       cpad: int, device) -> BlockTable:
    b = BLOCK_B
    s = b + 1
    nby, nbx = h // b, w // b
    ay = (np.arange(nby) * b)[:, None]
    ax = (np.arange(nbx) * b)[None, :]
    taps = [tex[(ay + j) % h, (ax + i) % w] for j in range(s)
            for i in range(s)]
    raw = np.concatenate(taps, axis=-1).reshape(nby * nbx, s * s * cpad)
    pad = (-raw.shape[1]) % 128
    if pad:
        raw = np.pad(raw, ((0, 0), (0, pad)))
    return BlockTable(blocks=torch.as_tensor(raw, device=device), height=h,
                      width=w, present=present)


def pack_material_maps(material_set, index: int) -> dict:
    """Slot → uint8 map dict for one material (level 0, per-map default
    fallback)."""
    from bibim_tpu_torch.assets.materials import PBRMapType

    def level0(t):
        return np.asarray(material_set.get_pbr_map_or_default(index, t)[0])

    alb = level0(PBRMapType.ALBEDO)
    nrm = level0(PBRMapType.NORMAL)
    return {
        "alb_r": alb[:, :, 0:1], "alb_g": alb[:, :, 1:2],
        "alb_b": alb[:, :, 2:3],
        "nrm_x": nrm[:, :, 0:1], "nrm_y": nrm[:, :, 1:2],
        "nrm_z": nrm[:, :, 2:3],
        "metallic": level0(PBRMapType.METALLIC),
        "roughness": level0(PBRMapType.ROUGHNESS),
        "ao": level0(PBRMapType.AO),
        "height": level0(PBRMapType.HEIGHT),
    }


def _footprint_ints(u, v, h: int, w: int):
    """Bilinear footprint: top-left texel (REPEAT-wrapped) + fractions."""
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    return x0i, y0i, tx, ty


def _footprint(u, v, h: int, w: int):
    """Flat quad index + (tx, ty)."""
    x0i, y0i, tx, ty = _footprint_ints(u, v, h, w)
    return y0i * w + x0i, tx, ty


def sample_table_xla(table: QuadTable, u, v) -> dict:
    """One row read per pixel + w00..w11 weighted blend (the JAX package's
    XLA sampler, same op order)."""
    shape = u.shape
    idx, tx, ty = _footprint(u.reshape(-1), v.reshape(-1), table.height,
                             table.width)
    q = table.quads[idx.long()].to(torch.float32) * _INV255
    cpad = q.shape[1] // 4
    w00 = ((1.0 - tx) * (1.0 - ty))[:, None]
    w01 = (tx * (1.0 - ty))[:, None]
    w10 = ((1.0 - tx) * ty)[:, None]
    w11 = (tx * ty)[:, None]
    out = (q[:, 0:cpad] * w00 + q[:, cpad:2 * cpad] * w01
           + q[:, 2 * cpad:3 * cpad] * w10 + q[:, 3 * cpad:] * w11)
    return {slot: out[:, k].reshape(shape)
            for k, slot in enumerate(table.present)}


def pair_factors(pair_rows) -> tuple:
    """(ry, rx) pixel-group factors of a pair_sampling level: 2×1 groups
    at level 1, 2×2 at level 2."""
    return 2, (2 if int(pair_rows) >= 2 else 1)


def _rep_min(p, vp):
    """Per-group window anchor of one axis: the min top-left tap over the
    group's covered members, or over all members where none is covered.
    ``p`` / ``vp``: (nt, hp, ry, wp, rx) tap / coverage planes → (nt, hp,
    wp)."""
    mn_cov = torch.where(vp, p, torch.full_like(p, 1 << 30)).amin(dim=(2, 4))
    return torch.where(vp.any(dim=(2, 4)), mn_cov, p.amin(dim=(2, 4)))


def pair_window(h: int, w: int, u, v, valid, pair_rows, tile_w: int = 128):
    """Group-rate block sampling of (NT, NPX) planes at a pair_sampling
    level (the JAX package's ``block_prep(pair_rows=)``): each group
    anchors one (B+1)² texel window at ``_rep_min`` of its members'
    top-left taps. Returns per pixel the anchor's block-row index and the
    top-left tap (cx, cy) relative to the anchor block, REPEAT-wrapped
    into [-w/2, w/2), with the footprint's fractions (tx, ty); a pixel is
    inside the window where 0 ≤ cx, cy ≤ B-1. ``valid`` None: every pixel
    covered."""
    nt, npx = u.shape
    b = BLOCK_B
    ry, rx = pair_factors(pair_rows)
    hp, wp = npx // tile_w // ry, tile_w // rx
    if hp * ry * tile_w != npx or wp * rx != tile_w:
        raise ValueError("pair sampling needs (NT, tile_h·tile_w) planes "
                         "with an even tile_h")
    x0i, y0i, tx, ty = _footprint_ints(u, v, h, w)
    if valid is None:
        valid = torch.ones(u.shape, dtype=torch.bool, device=u.device)

    def groups(p):
        return p.reshape(nt, hp, ry, wp, rx)

    def full(p):  # (nt, hp, wp) group plane → every member's pixel
        return p[:, :, None, :, None].expand(nt, hp, ry, wp, rx).reshape(
            nt, npx)

    vp = groups(valid)
    xr = _rep_min(groups(x0i), vp)
    yr = _rep_min(groups(y0i), vp)
    row = full((yr // b) * (w // b) + xr // b)
    cx = torch.remainder(x0i - full((xr // b) * b) + w // 2, w) - w // 2
    cy = torch.remainder(y0i - full((yr // b) * b) + h // 2, h) - h // 2
    return row, cx, cy, tx, ty


def _in_window(c):
    return (c >= 0) & (c <= BLOCK_B - 1)


def escape_tiles_hw(h: int, w: int, u, v, valid, pair_rows,
                    tile_w: int = 128) -> torch.Tensor:
    """(NT,) flags of the tiles where a covered pixel's footprint leaves
    its group's window at ``pair_rows`` (:func:`pair_window`, the
    sampler's own integer math): elsewhere group-rate sampling is
    bit-exact. From a table's (height, width) alone."""
    _, cx, cy, _, _ = pair_window(h, w, u, v, valid, pair_rows, tile_w)
    return (valid & ~(_in_window(cx) & _in_window(cy))).any(dim=1)


def escape_tiles(table: BlockTable, u, v, valid, pair_rows,
                 tile_w: int = 128) -> torch.Tensor:
    """:func:`escape_tiles_hw` of a bound block table."""
    return escape_tiles_hw(table.height, table.width, u, v, valid,
                           pair_rows, tile_w)


def _block_taps(table: BlockTable, u, v, pair_rows, valid, tile_w):
    """Flat (row index, lx, ly, tx, ty) of each pixel's 25-tap blend: its
    own block at pair level 0, else the group anchor's block with the
    taps clamped to the window edge (tx / ty exactly 0 or 1 there)."""
    b = BLOCK_B
    if not pair_rows:
        x0i, y0i, tx, ty = _footprint_ints(u.reshape(-1), v.reshape(-1),
                                           table.height, table.width)
        row = (y0i // b) * (table.width // b) + x0i // b
        return row, x0i % b, y0i % b, tx, ty
    row, cx, cy, tx, ty = pair_window(table.height, table.width, u, v,
                                      valid, pair_rows, tile_w)

    def clamp_frac(c, f):
        edge = torch.where(c < 0, torch.zeros_like(f), torch.ones_like(f))
        return torch.where(_in_window(c), f, edge)

    return (row.reshape(-1), torch.clamp(cx, 0, b - 1).reshape(-1),
            torch.clamp(cy, 0, b - 1).reshape(-1),
            clamp_frac(cx, tx).reshape(-1), clamp_frac(cy, ty).reshape(-1))


def sample_table_block(table: BlockTable, u, v, pair_rows: int = 0,
                       valid=None, tile_w: int = 128) -> dict:
    """One block-row read per pixel + the 25-tap (j, i) row-major blend;
    dead taps add exact zeros, so this equals the quad-table sampler.
    ``pair_rows`` 1 / 2: group-rate sampling (:func:`_block_taps`) of
    (NT, tile_h·tile_w) planes, ``valid`` the coverage that anchors each
    group's window (None: all)."""
    shape = u.shape
    b = BLOCK_B
    s = b + 1
    cpad = _ceil4(len(table.present))
    row, lx, ly, tx, ty = _block_taps(table, u, v, pair_rows, valid, tile_w)
    q = table.blocks[row.long()]
    qt = q.T.to(torch.float32) * _INV255  # (row_bytes, N)
    one_m_tx = 1.0 - tx
    one_m_ty = 1.0 - ty
    zero = torch.zeros_like(tx)
    acc = [None] * len(table.present)
    for j in range(s):
        wy = (torch.where(ly == j, one_m_ty, zero)
              + torch.where(ly + 1 == j, ty, zero))
        for i in range(s):
            wx = (torch.where(lx == i, one_m_tx, zero)
                  + torch.where(lx + 1 == i, tx, zero))
            wgt = wx * wy
            for c in range(len(table.present)):
                term = qt[(j * s + i) * cpad + c] * wgt
                acc[c] = term if acc[c] is None else acc[c] + term
    return {slot: acc[k].reshape(shape)
            for k, slot in enumerate(table.present)}


def _check_uv(fn: str, u, v) -> None:
    for name, t in (("u", u), ("v", v)):
        if (t.dtype != torch.float32 or t.device != u.device
                or t.shape != u.shape or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous float32 "
                             f"{tuple(u.shape)} tensor on {u.device}")


def _check_table(fn: str, tab: torch.Tensor, device) -> None:
    if (tab.dtype != torch.uint8 or tab.device != device
            or not tab.is_contiguous() or tab.ndim != 2):
        raise ValueError(f"{fn}: the table must be a contiguous 2-D uint8 "
                         f"tensor on {device}")


# The kernels' pair-rate warp mapping (csrc/shading.cuh pair_pixel): a
# warp covers 2 tile rows × 16 columns.
PAIR_TILE_W = 16


def check_pair_planes(fn: str, pair_rows, u, valid, tile_w: int) -> None:
    """The planes a kernel's pair-rate sample takes (K2, K6): (NT,
    tile_h·tile_w) with an even tile_h and ``tile_w`` a multiple of
    :data:`PAIR_TILE_W`; ``valid`` None or a contiguous bool plane of
    their shape and device."""
    if pair_rows not in (0, 1, 2):
        raise ValueError(f"{fn}: pair level {pair_rows} is not 0, 1 or 2")
    if not pair_rows:
        return
    if tile_w % PAIR_TILE_W:
        raise ValueError(f"{fn}: pair level {pair_rows} needs tile_w a "
                         f"multiple of {PAIR_TILE_W}, not {tile_w}")
    if u.ndim != 2 or u.shape[1] % (2 * tile_w):
        raise ValueError(f"{fn}: pair level {pair_rows} needs (NT, "
                         "tile_h·tile_w) planes with an even tile_h")
    if valid is not None and (
            valid.dtype != torch.bool or valid.shape != u.shape
            or valid.device != u.device or not valid.is_contiguous()):
        raise ValueError(f"{fn}: valid must be a contiguous bool plane of "
                         "the uv planes' shape")


def sample_table_block_kernel(table: BlockTable, u, v, pair_rows: int = 0,
                              valid=None, tile_w: int = 128) -> dict:
    """K6 wrapper (csrc/sample.cu): slot → plane sampled at planar uv;
    the same contract as :func:`sample_table_block`, which it runs only
    for CPU tensors. Launches at pair level 1 / 2 also count in
    ``pair_launches``."""
    _check_uv("sample_table_block_kernel", u, v)
    check_pair_planes("sample_table_block_kernel", pair_rows, u, valid,
                      tile_w)
    dev = u.device
    tab = table.blocks
    _check_table("sample_table_block_kernel", tab, dev)
    n_out = len(table.present)
    cpad = _ceil4(n_out)
    if table.height % BLOCK_B or table.width % BLOCK_B:
        raise ValueError("block tables need BLOCK_B-divisible sizes")
    if tab.shape[1] < (BLOCK_B + 1) ** 2 * cpad or n_out > len(SLOTS):
        raise ValueError("block table rows too short for their slots")
    if dev.type == "cpu":
        return sample_table_block(table, u, v, pair_rows, valid, tile_w)
    if dev.type != "cuda":
        raise RuntimeError(f"sample_table_block_kernel: unsupported device "
                           f"{dev}")
    # 16-byte aligned rows (word taps) and uv planes (vector loads).
    if any(t.data_ptr() % 16 for t in (tab, u, v)) or tab.shape[1] % 16:
        raise ValueError("sample_table_block_kernel: the table, its rows "
                         "and u, v must start on 16-byte boundaries")
    # Slot planes padded to whole 16-byte vectors (the kernel's stores).
    n = u.numel()
    ns = -(-n // 4) * 4
    out = torch.empty((n_out, ns), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.library().bb_sample_block(
        p(tab), tab.shape[1], table.height, table.width, cpad, n_out, p(u),
        p(v), None if valid is None else p(valid), int(pair_rows), tile_w,
        n, ns, p(out), _build.stream_ptr(dev))
    _build.check(err, "sample_block")
    sample_table_block_kernel.launches += 1
    if pair_rows:
        sample_table_block_kernel.pair_launches += 1
    return {slot: out[k, :n].view(u.shape)
            for k, slot in enumerate(table.present)}


sample_table_block_kernel.launches = 0
sample_table_block_kernel.pair_launches = 0


def sample_rows_small_plain(quads: torch.Tensor, idx, tx, ty,
                            present: tuple) -> dict:
    """Plain version of K7: quad row ``idx`` of each pixel (a row outside
    the table samples 0, as the reference's one-hot select does), blended
    in the ``_blend`` order."""
    shape = idx.shape
    rows = quads.shape[0]
    flat = idx.reshape(-1)
    ok = ((flat >= 0) & (flat < rows))[:, None]
    q = quads[torch.clamp(flat, 0, rows - 1).long()].to(torch.float32)
    q = torch.where(ok, q * _INV255, torch.zeros_like(q))
    cpad = q.shape[1] // 4
    txf, tyf = tx.reshape(-1), ty.reshape(-1)
    out = {}
    for k, slot in enumerate(present):
        top = q[:, k] * (1.0 - txf) + q[:, cpad + k] * txf
        bot = q[:, 2 * cpad + k] * (1.0 - txf) + q[:, 3 * cpad + k] * txf
        out[slot] = (top * (1.0 - tyf) + bot * tyf).reshape(shape)
    return out


def sample_rows_small(quads: torch.Tensor, idx, tx, ty,
                      present: tuple) -> dict:
    """K7 wrapper (csrc/sample.cu). ``quads`` (rows, 4·cpad) uint8;
    ``idx`` int32 and ``tx``/``ty`` float32 planes of one shape (the
    caller's footprint). Runs :func:`sample_rows_small_plain` only for CPU
    tensors."""
    dev = idx.device
    _check_table("sample_rows_small", quads, dev)
    n_out = len(present)
    cpad = _ceil4(n_out)
    if quads.shape[1] != 4 * cpad:
        raise ValueError("sample_rows_small: quad rows must hold 4·cpad "
                         "bytes")
    if (idx.dtype != torch.int32 or not idx.is_contiguous()
            or any(t.dtype != torch.float32 or t.shape != idx.shape
                   or t.device != dev or not t.is_contiguous()
                   for t in (tx, ty))):
        raise ValueError("sample_rows_small: idx must be a contiguous int32 "
                         "plane and tx/ty contiguous float32 planes of its "
                         "shape on its device")
    if dev.type == "cpu":
        return sample_rows_small_plain(quads, idx, tx, ty, present)
    if dev.type != "cuda":
        raise RuntimeError(f"sample_rows_small: unsupported device {dev}")
    out = torch.empty((n_out,) + tuple(idx.shape), dtype=torch.float32,
                      device=dev)
    p = _build.ptr
    err = _build.library().bb_sample_small(
        p(quads), quads.shape[0], cpad, n_out, p(idx), p(tx), p(ty),
        idx.numel(), p(out), _build.stream_ptr(dev))
    _build.check(err, "sample_small")
    sample_rows_small.launches += 1
    return {slot: out[k] for k, slot in enumerate(present)}


sample_rows_small.launches = 0


def sample_table_small_plain(table: QuadTable, u, v) -> dict:
    """Plain version of :func:`sample_table_small`."""
    idx, tx, ty = _footprint(u, v, table.height, table.width)
    return sample_rows_small_plain(table.quads, idx, tx, ty, table.present)


def sample_table_small(table: QuadTable, u, v) -> dict:
    """Quad-table sample at planar uv through K7 (footprint as torch
    ops)."""
    _check_uv("sample_table_small", u, v)
    idx, tx, ty = _footprint(u, v, table.height, table.width)
    return sample_rows_small(table.quads, idx, tx, ty, table.present)


def _fill_slots(out: dict, like) -> dict:
    for slot in SLOTS:
        out.setdefault(slot, torch.zeros_like(like))
    return out


def sample_material(tables: tuple, u, v, kernels=None, pair_rows: int = 0,
                    valid=None, tile_w: int = 128) -> dict:
    """Every SLOTS entry sampled at planar uv (missing slots are 0).

    ``kernels`` (``pipeline.Kernels``, or anything with ``sample_block``
    and ``sample_small``) routes as the JAX package's
    ``sample_material(use_pallas=True)``: block tables to
    ``kernels.sample_block`` (K6), quad tables of at most SMALL_ROWS rows
    to ``kernels.sample_small`` (K7, rows by footprint index), bigger ones
    to :func:`sample_table_xla`. ``kernels=None`` is its
    ``use_pallas=False`` form: :func:`sample_table_block` and
    :func:`sample_table_xla`. ``pair_rows`` / ``valid`` / ``tile_w``:
    group-rate sampling of the block tables (quad tables always sample
    per pixel)."""
    out = {}
    for table in tables:
        if isinstance(table, BlockTable):
            fn = sample_table_block if kernels is None \
                else kernels.sample_block
            out.update(fn(table, u, v, pair_rows=pair_rows, valid=valid,
                          tile_w=tile_w) if pair_rows else fn(table, u, v))
        elif (kernels is not None
              and table.height * table.width <= SMALL_ROWS):
            idx, tx, ty = _footprint(u, v, table.height, table.width)
            out.update(kernels.sample_small(table.quads, idx, tx, ty,
                                            table.present))
        else:
            out.update(sample_table_xla(table, u, v))
    return _fill_slots(out, u)


# ---------------------------------------------------------------------------
# Trilinear mips.
# ---------------------------------------------------------------------------


def build_mip_pyramid(level0: np.ndarray,
                      max_levels: int | None = None) -> list:
    """2×2 box-filtered mip chain of an (H, W, C) uint8 or float image
    (``bibim_tpu.assets.image.build_mip_pyramid``, same rounding): stops
    at 1×1 or after ``max_levels``; odd edges drop the trailing texel; the
    mean stays float32 across levels and each stored u8 level rounds with
    +0.5."""
    levels = [level0]
    cur = level0.astype(np.float32)
    while min(cur.shape[0], cur.shape[1]) > 1:
        if max_levels is not None and len(levels) >= max_levels:
            break
        h, w = (cur.shape[0] // 2) * 2, (cur.shape[1] // 2) * 2
        cur = cur[:h, :w].reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3))
        if level0.dtype == np.uint8:
            levels.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
        else:
            levels.append(cur.astype(level0.dtype))
    return levels


class MipQuadTable(NamedTuple):
    """Quad rows of every mip level of one size group, concatenated flat;
    level geometry static. ``paired`` rows (multi-level tables) append the
    parent level's 3×3 block anchored at ((y-1)>>1, (x-1)>>1): [own 2×2
    quad (4·cpad) | parent block (9·cpad)]."""

    quads: torch.Tensor  # (total_rows, 4*cpad or 13*cpad) uint8
    heights: tuple  # per level
    widths: tuple
    offsets: tuple  # per-level flat row offset
    present: tuple
    paired: bool = False


class MipQuadMulti(NamedTuple):
    """One slot group of MipQuadTables of several materials merged flat;
    ``heights``/``widths``/``offsets`` are [material][level]."""

    quads: torch.Tensor
    heights: tuple
    widths: tuple
    offsets: tuple
    present: tuple
    paired: bool = False


# Mip block rows: the 5×5 child neighbourhood of a 4×4 texel block and the
# covering 4×4 parent neighbourhood, channel stride len(present).
MB_B = 4  # texels per block edge
MB_S = MB_B + 1  # child taps per axis
MB_P = 4  # parent taps per axis
MB_TAPS = MB_S * MB_S + MB_P * MB_P  # 41


class MipBlockMulti(NamedTuple):
    """Mip block tables of one slot group of one or more materials merged
    flat; ``offsets`` are block-row offsets [material][level] (built levels
    only). ``last_parent[mat]``: the deepest built level still stores real
    parent taps (the pyramid continues below it), so frac may stay > 0
    there."""

    blocks: torch.Tensor  # (total_blocks, row_bytes) uint8, row_bytes % 128 == 0
    heights: tuple
    widths: tuple
    offsets: tuple
    present: tuple
    last_parent: tuple  # [mat] bool


def _group_mips(mip_maps: dict) -> dict:
    """slot → mip list grouped by level-0 resolution."""
    groups: dict = {}
    for slot, mips in mip_maps.items():
        key = (int(mips[0].shape[0]), int(mips[0].shape[1]))
        groups.setdefault(key, {})[slot] = mips
    return groups


def _level_texs(slot_mips: dict, present: tuple, cpad: int) -> list:
    """Per level, the group's slots packed into (h, w, cpad) u8 texels."""
    levels = len(next(iter(slot_mips.values())))
    texs = []
    for li in range(levels):
        any_level = next(iter(slot_mips.values()))[li]
        tex = np.zeros((int(any_level.shape[0]), int(any_level.shape[1]),
                        cpad), np.uint8)
        for k, slot in enumerate(present):
            img = slot_mips[slot][li]
            tex[:, :, k] = img[:, :, 0] if img.ndim == 3 else img
        texs.append(tex)
    return texs


def build_mip_quad_tables(mip_maps: dict, device="cuda") -> tuple:
    """``mip_maps``: slot → list of (H_l, W_l[, ≥1]) uint8 levels (level 0
    first). Slots group by level-0 resolution; multi-level groups build
    paired rows (the last level's parent block is zeros)."""
    tables = []
    for _, slot_mips in sorted(_group_mips(mip_maps).items()):
        present = tuple(sorted(slot_mips, key=SLOTS.index))
        cpad = _ceil4(len(present))
        texs = _level_texs(slot_mips, present, cpad)
        paired = len(texs) > 1
        heights, widths, offsets, parts = [], [], [], []
        off = 0
        for li, tex in enumerate(texs):
            h, w = tex.shape[:2]
            t01 = np.roll(tex, -1, axis=1)
            t10 = np.roll(tex, -1, axis=0)
            t11 = np.roll(t01, -1, axis=0)
            own = np.concatenate([tex, t01, t10, t11], axis=-1)
            if paired:
                if li + 1 < len(texs):
                    par = texs[li + 1]
                    h2, w2 = par.shape[:2]
                    ay = ((np.arange(h) - 1) >> 1)[:, None]
                    ax = ((np.arange(w) - 1) >> 1)[None, :]
                    pblk = np.concatenate(
                        [par[(ay + j) % h2, (ax + i) % w2]
                         for j in range(3) for i in range(3)], axis=-1)
                else:
                    pblk = np.zeros((h, w, 9 * cpad), np.uint8)
                own = np.concatenate([own, pblk], axis=-1)
            parts.append(own.reshape(h * w, -1))
            heights.append(h)
            widths.append(w)
            offsets.append(off)
            off += h * w
        tables.append(MipQuadTable(
            quads=torch.as_tensor(np.concatenate(parts, axis=0),
                                  device=device),
            heights=tuple(heights), widths=tuple(widths),
            offsets=tuple(offsets), present=present, paired=paired))
    return tuple(tables)


def _by_present(materials: tuple) -> tuple:
    """(per-material {present: table}, sorted present keys); raises when
    the materials partition their slots differently."""
    by_present = [{t.present: t for t in mat} for mat in materials]
    keys = set(by_present[0])
    for bp in by_present[1:]:
        if set(bp) != keys:
            raise ValueError("materials partition slots differently — "
                             f"cannot merge ({sorted(keys)} vs "
                             f"{sorted(bp)})")
    return by_present, sorted(keys)


def merge_mip_quad_materials(materials: tuple) -> tuple:
    """Per-material MipQuadTable tuples → MipQuadMulti groups."""
    by_present, keys = _by_present(materials)
    merged = []
    for present in keys:
        tabs = [bp[present] for bp in by_present]
        paired = {t.paired for t in tabs}
        if len(paired) != 1:
            raise ValueError(f"slot group {present}: cannot merge "
                             "single-level and multi-level materials")
        offsets, base = [], 0
        for t in tabs:
            offsets.append(tuple(o + base for o in t.offsets))
            base += t.quads.shape[0]
        merged.append(MipQuadMulti(
            quads=torch.cat([t.quads for t in tabs]),
            heights=tuple(t.heights for t in tabs),
            widths=tuple(t.widths for t in tabs), offsets=tuple(offsets),
            present=present, paired=paired.pop()))
    return tuple(merged)


def _build_mip_block_group(texs: list, present: tuple,
                           device) -> MipBlockMulti:
    """One material's pyramid ((h, w, cs) u8 levels) as block rows. Levels
    build while the sizes stay 4-divisible; the tail of the pyramid is
    reachable only through the last built level's stored parent taps."""
    cs = len(present)
    row_bytes = -(-(MB_TAPS * cs) // 128) * 128
    heights, widths, offsets, parts = [], [], [], []
    off = 0
    for li, tex in enumerate(texs):
        h, w = tex.shape[:2]
        if h % MB_B or w % MB_B or h < MB_B or w < MB_B:
            break
        has_next = li + 1 < len(texs)
        if has_next and texs[li + 1].shape[:2] != (h // 2, w // 2):
            raise ValueError("mip pyramid must halve exactly per level "
                             f"({texs[li + 1].shape[:2]} after ({h}, {w}))")
        nby, nbx = h // MB_B, w // MB_B
        ay = (np.arange(nby) * MB_B)[:, None]
        ax = (np.arange(nbx) * MB_B)[None, :]
        taps = [tex[(ay + j) % h, (ax + i) % w]
                for j in range(MB_S) for i in range(MB_S)]
        if has_next:
            par = texs[li + 1]
            h2, w2 = par.shape[:2]
            py = (np.arange(nby) * 2 - 1)[:, None]
            px = (np.arange(nbx) * 2 - 1)[None, :]
            taps += [par[(py + j) % h2, (px + i) % w2]
                     for j in range(MB_P) for i in range(MB_P)]
        else:  # true last level: frac is forced to 0, the taps unused
            taps += [np.zeros((nby, nbx, cs), np.uint8)] * (MB_P * MB_P)
        raw = np.concatenate(taps, axis=-1).reshape(nby * nbx, MB_TAPS * cs)
        parts.append(np.pad(raw, ((0, 0), (0, row_bytes - raw.shape[1]))))
        heights.append(h)
        widths.append(w)
        offsets.append(off)
        off += nby * nbx
    if not parts:
        raise ValueError("mip block tables need a ≥4×4, 4-divisible base")
    return MipBlockMulti(
        blocks=torch.as_tensor(np.concatenate(parts, axis=0), device=device),
        heights=(tuple(heights),), widths=(tuple(widths),),
        offsets=(tuple(offsets),), present=present,
        last_parent=(len(heights) < len(texs),))


def build_mip_block_tables(mip_maps: dict, device="cuda") -> tuple:
    """Like :func:`build_mip_quad_tables` but as single-material
    MipBlockMulti groups; groups with a base below 4×4, not 4-divisible,
    or a single level keep the quad layout."""
    tables = []
    for (h0, w0), slot_mips in sorted(_group_mips(mip_maps).items()):
        present = tuple(sorted(slot_mips, key=SLOTS.index))
        levels = len(next(iter(slot_mips.values())))
        if h0 % MB_B or w0 % MB_B or h0 < MB_B or w0 < MB_B or levels == 1:
            tables.extend(build_mip_quad_tables(
                {s: slot_mips[s] for s in present}, device))
            continue
        texs = _level_texs(slot_mips, present, len(present))
        tables.append(_build_mip_block_group(texs, present, device))
    return tuple(tables)


def merge_mip_block_materials(materials: tuple) -> tuple:
    """Per-material tuples from :func:`build_mip_block_tables` → merged
    MipBlockMulti groups, then the quad-layout groups merged by
    :func:`merge_mip_quad_materials`."""
    by_present, keys = _by_present(materials)
    merged, quad_groups = [], []
    for present in keys:
        tabs = [bp[present] for bp in by_present]
        kinds = {type(t) for t in tabs}
        if kinds == {MipQuadTable}:
            quad_groups.append(tabs)
            continue
        if kinds != {MipBlockMulti}:
            raise ValueError(f"slot group {present}: mixed block/quad "
                             "layouts across materials")
        if any(len(t.heights) != 1 for t in tabs):
            raise ValueError("merge inputs must be single-material")
        if len({t.blocks.shape[1] for t in tabs}) != 1:
            raise ValueError("row-byte widths differ across materials")
        offsets, base = [], 0
        for t in tabs:
            offsets.append(tuple(o + base for o in t.offsets[0]))
            base += t.blocks.shape[0]
        merged.append(MipBlockMulti(
            blocks=torch.cat([t.blocks for t in tabs]),
            heights=tuple(t.heights[0] for t in tabs),
            widths=tuple(t.widths[0] for t in tabs), offsets=tuple(offsets),
            present=present,
            last_parent=tuple(t.last_parent[0] for t in tabs)))
    if quad_groups:
        merged.extend(merge_mip_quad_materials(tuple(
            tuple(g[m] for g in quad_groups)
            for m in range(len(materials)))))
    return tuple(merged)


def _quad_diffs_planar(x, tile_h: int, tile_w: int):
    """2×2 pixel-quad differences (d/dx, d/dy) of a tiled-planar
    (NT, NPX) plane: the GPU derivative model (tiles start on even pixel
    coordinates, so the quads are image-space quads)."""
    nt, npx = x.shape
    a = x.reshape(nt, tile_h // 2, 2, tile_w // 2, 2)
    dx = (a[..., 1:2] - a[..., 0:1]).expand(a.shape).reshape(nt, npx)
    dy = (a[:, :, 1:2] - a[:, :, 0:1]).expand(a.shape).reshape(nt, npx)
    return dx, dy


def aniso_uv_steps(u, v, tile_h: int, tile_w: int):
    """Per-pixel major-axis uv footprint (du, dv): the longer (in uv) of
    the pixel quad's two screen-axis uv differences, x on a tie. The
    frame's N-tap anisotropic sampling averages bilinear taps at
    uv + t·(du, dv), t = (i + ½)/N − ½."""
    du_dx, du_dy = _quad_diffs_planar(u, tile_h, tile_w)
    dv_dx, dv_dy = _quad_diffs_planar(v, tile_h, tile_w)
    pick_x = (du_dx * du_dx + dv_dx * dv_dx
              >= du_dy * du_dy + dv_dy * dv_dy)
    return (torch.where(pick_x, du_dx, du_dy),
            torch.where(pick_x, dv_dx, dv_dy))


def quad_lod_planar(u, v, tile_h: int, tile_w: int, tex_h, tex_w):
    """Per-pixel LOD ≥ 0 from 2×2 pixel-quad uv differences;
    ``tex_h``/``tex_w`` are level-0 sizes (numbers or per-pixel float32
    planes)."""
    du_dx, du_dy = _quad_diffs_planar(u, tile_h, tile_w)
    dv_dx, dv_dy = _quad_diffs_planar(v, tile_h, tile_w)
    w = float(tex_w) if isinstance(tex_w, int) else tex_w
    h = float(tex_h) if isinstance(tex_h, int) else tex_h
    rho_x = torch.sqrt((du_dx * w) ** 2 + (dv_dx * h) ** 2)
    rho_y = torch.sqrt((du_dy * w) ** 2 + (dv_dy * h) ** 2)
    lod = torch.log2(torch.clamp(torch.maximum(rho_x, rho_y), min=1e-12))
    return torch.clamp(lod, min=0.0)


def _mat_plane(mat_id, like):
    return torch.zeros(like.shape, dtype=torch.int32, device=like.device) \
        if mat_id is None else mat_id


@functools.lru_cache(maxsize=256)
def _lookup(values: tuple, dtype, device) -> torch.Tensor:
    """A small constant table on ``device``, made once: building it from a
    list on every call would copy from pageable host memory each time,
    which waits for the device."""
    return torch.tensor(values, dtype=dtype, device=device)


def _per_mat(values, mat, dtype):
    """``values[mat]`` per pixel; an out-of-range id reads material 0 (the
    JAX package's where-chain starts from material 0)."""
    t = _lookup(tuple(values), dtype, mat.device)
    ok = (mat >= 0) & (mat < len(values))
    return t[torch.where(ok, mat, torch.zeros_like(mat)).long()]


def _per_mat_level(values, mat, lvl, default, dtype):
    """``values[mat][lvl]`` per pixel; ``default`` where the id is out of
    range (no (material, level) select matches in the where-chain).
    ``lvl`` is within the selected material's levels."""
    n = max(len(v) for v in values)
    rows = [tuple(v) + (default,) * (n - len(v)) for v in values]
    t = _lookup(sum(rows, ()) + (default,) * n, dtype, mat.device)
    ok = (mat >= 0) & (mat < len(values))
    row = torch.where(ok, mat, torch.full_like(mat, len(values)))
    return t[row.long() * n + lvl.long()]


def _level_select(heights, mat, lod):
    """(l0, frac, max_level): the floored level clipped to the material's
    chain and the blend fraction."""
    max_level = _per_mat([len(h) - 1 for h in heights], mat, torch.int32)
    l0 = torch.minimum(torch.clamp(torch.floor(lod).to(torch.int32), min=0),
                       max_level)
    frac = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)
    return l0, frac, max_level


def _mip_block_geometry(table: MipBlockMulti, mat_id, u, v, tile_h: int,
                        tile_w: int) -> dict:
    """Per-pixel planes for block-row trilinear sampling, all (NT, NPX):
    the row index ``idx``, child tap (lx, ly, tx, ty), parent tap (pxi,
    pyi, tx2, ty2), the level blend ``frac`` and the level ``l0``.

    Child block bx covers texels [4bx, 4bx+4), so the parent coordinate
    x02 = floor(fx/2) lies in {2bx−1, 2bx, 2bx+1} and pxi = (x02 −
    (2bx−1)) mod w2 indexes the stored [2bx−1, 2bx+3) window (REPEAT wraps
    keep the residue: w is even)."""
    mat = _mat_plane(mat_id, u)
    lod = quad_lod_planar(
        u, v, tile_h, tile_w,
        _per_mat([float(h[0]) for h in table.heights], mat, torch.float32),
        _per_mat([float(w[0]) for w in table.widths], mat, torch.float32))
    l0, frac, max_level = _level_select(table.heights, mat, lod)
    # At the deepest built level frac blends into the stored parent taps
    # when the pyramid continues; a true last level forces frac to 0.
    no_parent = _per_mat([not p for p in table.last_parent], mat, torch.bool)
    frac = torch.where((l0 == max_level) & no_parent, torch.zeros_like(frac),
                       frac)

    h = _per_mat_level([[float(x) for x in hs] for hs in table.heights], mat,
                       l0, 1.0, torch.float32)
    w = _per_mat_level([[float(x) for x in ws] for ws in table.widths], mat,
                       l0, 1.0, torch.float32)
    off = _per_mat_level(table.offsets, mat, l0, 0, torch.int32)
    nbx = _per_mat_level([[x // MB_B for x in ws] for ws in table.widths],
                         mat, l0, 1, torch.int32)

    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wi = w.to(torch.int32)
    hi = h.to(torch.int32)
    x0i = torch.remainder(x0.to(torch.int32), wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    bx = x0i // MB_B
    by = y0i // MB_B
    w2i = torch.clamp(wi // 2, min=1)
    h2i = torch.clamp(hi // 2, min=1)
    fx2 = u * w2i.to(torch.float32) - 0.5
    fy2 = v * h2i.to(torch.float32) - 0.5
    x02 = torch.floor(fx2)
    y02 = torch.floor(fy2)
    return {
        "idx": off + by * nbx + bx,
        "lx": x0i - bx * MB_B, "ly": y0i - by * MB_B,
        "tx": fx - x0, "ty": fy - y0,
        "pxi": torch.remainder(x02.to(torch.int32) - (2 * bx - 1), w2i),
        "pyi": torch.remainder(y02.to(torch.int32) - (2 * by - 1), h2i),
        "tx2": fx2 - x02, "ty2": fy2 - y02,
        "frac": frac, "l0": l0,
    }


# Geometry planes K2's mip-block group reads, in csrc's order (shading.cuh
# MipGeom).
MIP_INT_PLANES = ("idx", "lx", "ly", "pxi", "pyi")
MIP_FLOAT_PLANES = ("tx", "ty", "tx2", "ty2", "frac")


def mip_geometry_planes(g: dict) -> tuple:
    """(5, N) int32 and (5, N) float32 stacks of the geometry planes."""
    return (torch.stack([g[k].reshape(-1) for k in MIP_INT_PLANES]),
            torch.stack([g[k].reshape(-1) for k in MIP_FLOAT_PLANES]))


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


@functools.lru_cache(maxsize=64)
def _mip_levels(heights: tuple, widths: tuple, offsets: tuple,
                last_parent: tuple) -> tuple:
    nlev = max(len(h) for h in heights)
    f = _f32_bits
    head, lev = (), ()
    for h, w, o, lp in zip(heights, widths, offsets, last_parent):
        head += (f(h[0]), f(w[0]), len(h) - 1, int(not lp))
        for i in range(nlev):
            hi, wi, oi = (h[i], w[i], o[i]) if i < len(h) else (1, 1, 0)
            lev += (hi, wi, oi, wi // MB_B, f(hi), f(wi),
                    f(max(hi // 2, 1)), f(max(wi // 2, 1)))
    return head + lev, nlev


def mip_level_table(table: MipBlockMulti) -> tuple:
    """(int32 words, nlev): the per-material numbers K8's geometry reads
    (csrc/shading.cuh ``mip_geometry``). For each material 4 words: its
    level-0 height and width as float32 bits, its last level and whether
    that level has no stored parent (``_per_mat``'s values). Then for
    each material and each of ``nlev`` levels 8 words: height, width,
    first row, blocks a row (``_per_mat_level``'s), and height, width,
    half height and half width (at least 1) as float32 bits. A material's
    levels past its last are never read and hold a 1 × 1 level at row 0."""
    return _mip_levels(table.heights, table.widths, table.offsets,
                       table.last_parent)


def mip_block_blend(blocks: torch.Tensor, g: dict, cs: int,
                    n_out: int) -> list:
    """The 41-tap trilinear blend of the JAX package's
    ``mip_block_blend_acc``, on the 8 live taps: each pixel's row ``idx``,
    child taps in w00/w01/w10/w11 order (the other 21 add exact zeros),
    then parent taps likewise (a parent tap outside the stored 4×4 window
    adds nothing), then own·(1−frac) + par·frac. ``g``: flat (N,) planes.
    Returns n_out (N,) planes."""
    flat = blocks.reshape(-1)
    base = g["idx"].long() * blocks.shape[1]
    lx, ly, pxi, pyi = (g[k].long() for k in ("lx", "ly", "pxi", "pyi"))
    tx, ty, tx2, ty2, frac = (g[k] for k in MIP_FLOAT_PLANES)
    o00 = base + (ly * MB_S + lx) * cs
    child = ((o00, (1.0 - tx) * (1.0 - ty)),
             (o00 + cs, tx * (1.0 - ty)),
             (o00 + MB_S * cs, (1.0 - tx) * ty),
             (o00 + (MB_S + 1) * cs, tx * ty))
    p00 = base + (MB_S * MB_S + pyi * MB_P + pxi) * cs
    mx0, mx1 = pxi < MB_P, pxi + 1 < MB_P
    my0, my1 = pyi < MB_P, pyi + 1 < MB_P
    parent = ((p00, (1.0 - tx2) * (1.0 - ty2), mx0 & my0),
              (p00 + cs, tx2 * (1.0 - ty2), mx1 & my0),
              (p00 + MB_P * cs, (1.0 - tx2) * ty2, mx0 & my1),
              (p00 + (MB_P + 1) * cs, tx2 * ty2, mx1 & my1))
    parent = tuple((torch.where(m, o, base), wt, m) for o, wt, m in parent)
    one_m_fr = 1.0 - frac
    zero = torch.zeros_like(frac)
    out = []
    for c in range(n_out):
        def tap(o):
            return flat[o + c].to(torch.float32) * _INV255

        own = None
        for o, wt in child:
            term = tap(o) * wt
            own = term if own is None else own + term
        par = None
        for o, wt, m in parent:
            term = torch.where(m, tap(o) * wt, zero)
            par = term if par is None else par + term
        out.append(own * one_m_fr + par * frac)
    return out


def sample_mip_block(table: MipBlockMulti, mat_id, u, v, tile_h: int = 8,
                     tile_w: int = 128) -> dict:
    """Plain version of K8: block-row trilinear sample → slot planes."""
    g = _mip_block_geometry(table, mat_id, u, v, tile_h, tile_w)
    cs = len(table.present)
    acc = mip_block_blend(table.blocks, {k: x.reshape(-1)
                                         for k, x in g.items()}, cs, cs)
    return {slot: acc[k].reshape(u.shape)
            for k, slot in enumerate(table.present)}


def _check_mat(fn: str, mat_id, u) -> None:
    if mat_id is not None and (
            mat_id.dtype != torch.int32 or mat_id.shape != u.shape
            or mat_id.device != u.device):
        raise ValueError(f"{fn}: mat_id must be an int32 {tuple(u.shape)} "
                         f"plane on {u.device}")


def sample_mip_block_kernel(table: MipBlockMulti, mat_id, u, v,
                            tile_h: int = 8, tile_w: int = 128) -> dict:
    """K8 wrapper (csrc/mip_sample.cu): slot → plane trilinear-sampled at
    planar (NT, tile_h·tile_w) uv with per-pixel material ids (None: all
    material 0). One launch: the kernel computes the LOD and footprint
    from uv and the ids (:func:`mip_level_table`, made once per binding)
    and blends. Runs :func:`sample_mip_block` only for CPU tensors."""
    _check_uv("sample_mip_block_kernel", u, v)
    _check_mat("sample_mip_block_kernel", mat_id, u)
    dev = u.device
    tab = table.blocks
    _check_table("sample_mip_block_kernel", tab, dev)
    cs = len(table.present)
    if (tab.shape[1] % 128 or tab.shape[1] < MB_TAPS * cs
            or not 0 < cs <= len(SLOTS)):
        raise ValueError("sample_mip_block_kernel: block rows must be a "
                         "128-byte multiple holding 41 taps of each slot")
    if u.ndim != 2 or u.shape[1] != tile_h * tile_w:
        raise ValueError("sample_mip_block_kernel: uv must be (NT, "
                         "tile_h·tile_w) tiled planes")
    if dev.type == "cpu":
        return sample_mip_block(table, mat_id, u, v, tile_h, tile_w)
    if dev.type != "cuda":
        raise RuntimeError(f"sample_mip_block_kernel: unsupported device "
                           f"{dev}")
    if tile_h % 2 or tile_w % 16:
        raise ValueError("sample_mip_block_kernel: tiles must hold whole "
                         "pixel quads in rows of 16-pixel runs")
    levels, nlev = mip_level_table(table)
    lv = _lookup(levels, torch.int32, dev)
    mat = None if mat_id is None else mat_id.contiguous()
    out = torch.empty((cs,) + tuple(u.shape), dtype=torch.float32,
                      device=dev)
    p = _build.ptr
    err = _build.library().bb_sample_mip_block(
        p(tab), tab.shape[1], cs, p(lv), len(table.heights), nlev, p(u),
        p(v), None if mat is None else p(mat),
        u.shape[0], tile_h, tile_w, p(out), _build.stream_ptr(dev))
    _build.check(err, "sample_mip_block")
    sample_mip_block_kernel.launches += 1
    return {slot: out[k] for k, slot in enumerate(table.present)}


sample_mip_block_kernel.launches = 0


def small_footprint_multi(table: MipQuadMulti, mat_id, u, v):
    """Material-routed footprint of a single-level merged quad group:
    (row idx, tx, ty), each material's footprint plus its row offset,
    selected per pixel (an out-of-range id takes material 0's)."""
    mat = _mat_plane(mat_id, u)
    idx = tx = ty = None
    for mi in range(len(table.heights)):
        i_m, tx_m, ty_m = _footprint(u, v, table.heights[mi][0],
                                     table.widths[mi][0])
        i_m = i_m + table.offsets[mi][0]
        if idx is None:
            idx, tx, ty = i_m, tx_m, ty_m
            continue
        is_m = mat == mi
        idx = torch.where(is_m, i_m, idx)
        tx = torch.where(is_m, tx_m, tx)
        ty = torch.where(is_m, ty_m, ty)
    return idx, tx, ty


def _sample_level(quads, cpad: int, h, w, off, uf, vf):
    """Bilinear sample of quad rows (the w00..w11 order) at the per-pixel
    level geometry ``h``/``w`` (float) and row offset ``off`` → (the
    blend, the rows as float taps, floored texel coordinates x0, y0)."""
    fx = uf * w - 0.5
    fy = vf * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    wi = w.to(torch.int32)
    hi = h.to(torch.int32)
    x0i = torch.remainder(x0.to(torch.int32), wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    q = quads[(off + y0i * wi + x0i).long()].to(torch.float32) * _INV255
    w00 = ((1.0 - tx) * (1.0 - ty))[:, None]
    w01 = (tx * (1.0 - ty))[:, None]
    w10 = ((1.0 - tx) * ty)[:, None]
    w11 = (tx * ty)[:, None]
    own = (q[:, 0:cpad] * w00 + q[:, cpad:2 * cpad] * w01
           + q[:, 2 * cpad:3 * cpad] * w10 + q[:, 3 * cpad:4 * cpad] * w11)
    return own, q, x0, y0


def _sample_paired(quads, cpad: int, h, w, off, uf, vf, frac):
    """One-row trilinear sample of paired quad rows [own 2×2 quad | parent
    3×3 block]."""
    own, q, x0, y0 = _sample_level(quads, cpad, h, w, off, uf, vf)
    # The parent footprint's 2×2 taps lie inside the stored 3×3 block
    # anchored at ((x0-1)>>1, (y0-1)>>1).
    w2 = torch.clamp(w.to(torch.int32) // 2, min=1).to(torch.float32)
    h2 = torch.clamp(h.to(torch.int32) // 2, min=1).to(torch.float32)
    fx2 = uf * w2 - 0.5
    fy2 = vf * h2 - 0.5
    x02 = torch.floor(fx2)
    y02 = torch.floor(fy2)
    tx2 = fx2 - x02
    ty2 = fy2 - y02
    dx1 = (torch.clamp(x02.to(torch.int32)
                       - ((x0.to(torch.int32) - 1) >> 1), 0, 1) == 1)[:, None]
    dy1 = (torch.clamp(y02.to(torch.int32)
                       - ((y0.to(torch.int32) - 1) >> 1), 0, 1) == 1)[:, None]
    base = 4 * cpad

    def p(j, i):
        c0 = base + (j * 3 + i) * cpad
        return q[:, c0:c0 + cpad]

    def tap(jj, ii):
        return torch.where(
            dy1, torch.where(dx1, p(jj + 1, ii + 1), p(jj + 1, ii)),
            torch.where(dx1, p(jj, ii + 1), p(jj, ii)))

    par = (tap(0, 0) * ((1.0 - tx2) * (1.0 - ty2))[:, None]
           + tap(0, 1) * (tx2 * (1.0 - ty2))[:, None]
           + tap(1, 0) * ((1.0 - tx2) * ty2)[:, None]
           + tap(1, 1) * (tx2 * ty2)[:, None])
    fr = frac[:, None]
    return own * (1.0 - fr) + par * fr


def _as_multi(table) -> MipQuadMulti:
    """A MipQuadTable as the one-material MipQuadMulti."""
    if isinstance(table, MipQuadMulti):
        return table
    return MipQuadMulti(table.quads, (table.heights,), (table.widths,),
                        (table.offsets,), table.present, table.paired)


def sample_mip_multi(table, mat_id, u, v, tile_h: int = 8,
                     tile_w: int = 128) -> dict:
    """The quad-layout trilinear oracle (the JAX package's
    ``sample_mip_multi``; a MipQuadTable is its one-material case):
    paired rows read once per pixel, unpaired rows at levels l0 and l0+1
    blended by frac."""
    shape = u.shape
    table = _as_multi(table)
    mat = _mat_plane(mat_id, u)
    lod = quad_lod_planar(
        u, v, tile_h, tile_w,
        _per_mat([float(h[0]) for h in table.heights], mat, torch.float32),
        _per_mat([float(w[0]) for w in table.widths], mat, torch.float32))
    l0, frac, max_level = _level_select(table.heights, mat, lod)
    uf, vf, matf = u.reshape(-1), v.reshape(-1), mat.reshape(-1)
    hs = [[float(x) for x in h] for h in table.heights]
    ws = [[float(x) for x in w] for w in table.widths]

    def geom(lsel):
        return (_per_mat_level(hs, matf, lsel, 1.0, torch.float32),
                _per_mat_level(ws, matf, lsel, 1.0, torch.float32),
                _per_mat_level(table.offsets, matf, lsel, 0, torch.int32))

    if table.paired:
        cpad = table.quads.shape[1] // 13
        frac = torch.where(l0 == max_level, torch.zeros_like(frac), frac)
        out = _sample_paired(table.quads, cpad, *geom(l0.reshape(-1)), uf,
                             vf, frac.reshape(-1))
    else:
        cpad = table.quads.shape[1] // 4
        top = max_level.reshape(-1)
        s0 = _sample_level(table.quads, cpad,
                           *geom(torch.minimum(l0.reshape(-1), top)), uf,
                           vf)[0]
        s1 = _sample_level(table.quads, cpad,
                           *geom(torch.minimum(l0.reshape(-1) + 1, top)), uf,
                           vf)[0]
        fr = frac.reshape(-1)[:, None]
        out = s0 * (1.0 - fr) + s1 * fr
    return {slot: out[:, k].reshape(shape)
            for k, slot in enumerate(table.present)}


def sample_mip_table(table: MipQuadTable, u, v, tile_h: int = 8,
                     tile_w: int = 128) -> dict:
    """Trilinear sample of a one-material MipQuadTable (planar uv)."""
    return sample_mip_multi(table, None, u, v, tile_h, tile_w)


def sample_material_mips_multi(tables: tuple, mat_id, u, v,
                               tile_h: int = 8, tile_w: int = 128,
                               kernels=None) -> dict:
    """Every SLOTS entry of merged mip groups (MipBlockMulti /
    MipQuadMulti, or one material's MipQuadTables) at planar uv, routed
    per pixel by ``mat_id`` (missing slots are 0).

    With ``kernels`` (``pipeline.Kernels``) as the JAX package's
    ``use_pallas=True``: block groups → ``kernels.sample_mip_block`` (K8);
    single-level groups of at most SMALL_ROWS rows →
    ``kernels.sample_small`` (K7) at the material-routed row index; other
    quad groups → :func:`sample_mip_multi`. ``kernels=None`` is its
    ``use_pallas=False`` form: :func:`sample_mip_block` and
    :func:`sample_mip_multi`."""
    out = {}
    for table in tables:
        if isinstance(table, MipBlockMulti):
            fn = sample_mip_block if kernels is None \
                else kernels.sample_mip_block
            out.update(fn(table, mat_id, u, v, tile_h, tile_w))
            continue
        table = _as_multi(table)
        if (kernels is not None and all(len(h) == 1 for h in table.heights)
                and table.quads.shape[0] <= SMALL_ROWS):
            idx, tx, ty = small_footprint_multi(table, mat_id, u, v)
            out.update(kernels.sample_small(table.quads, idx, tx, ty,
                                            table.present))
        else:
            out.update(sample_mip_multi(table, mat_id, u, v, tile_h,
                                        tile_w))
    return _fill_slots(out, u)
