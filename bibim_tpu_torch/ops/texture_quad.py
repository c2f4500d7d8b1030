"""Material tables and their plain samplers (port of
``bibim_tpu.ops.texture_quad``, per-pixel sampling only).

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
  ``sample_table_block_pallas`` at pair_rows=0); plain version
  :func:`sample_table_block`;
- K7, :func:`sample_rows_small` / :func:`sample_table_small`
  (csrc/sample.cu, replaces ``sample_rows_small_pallas`` /
  ``sample_table_small_pallas``); plain versions
  :func:`sample_rows_small_plain` / :func:`sample_table_small_plain`, in
  the kernel's ``_blend`` order (top/bottom rows first);

and :func:`sample_table_xla`, the JAX package's XLA sampler (w00..w11
order), which the debug ("full") frame and big quad tables use.
:func:`sample_material` dispatches between them as the JAX package does.
"""

from __future__ import annotations

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
                      device="cpu") -> tuple:
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
    from bibim_tpu.assets.materials import PBRMapType

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


def sample_table_block(table: BlockTable, u, v) -> dict:
    """One block-row read per pixel + the 25-tap (j, i) row-major blend;
    dead taps add exact zeros, so this equals the quad-table sampler."""
    shape = u.shape
    b = BLOCK_B
    s = b + 1
    nbx = table.width // b
    cpad = _ceil4(len(table.present))
    x0i, y0i, tx, ty = _footprint_ints(u.reshape(-1), v.reshape(-1),
                                       table.height, table.width)
    q = table.blocks[((y0i // b) * nbx + (x0i // b)).long()]
    qt = q.T.to(torch.float32) * _INV255  # (row_bytes, N)
    lx = x0i % b
    ly = y0i % b
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


def sample_table_block_kernel(table: BlockTable, u, v) -> dict:
    """K6 wrapper (csrc/sample.cu): slot → plane sampled at planar uv;
    the same contract as :func:`sample_table_block`, which it runs only
    for CPU tensors."""
    _check_uv("sample_table_block_kernel", u, v)
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
        return sample_table_block(table, u, v)
    if dev.type != "cuda":
        raise RuntimeError(f"sample_table_block_kernel: unsupported device "
                           f"{dev}")
    out = torch.empty((n_out,) + tuple(u.shape), dtype=torch.float32,
                      device=dev)
    p = _build.ptr
    err = _build.library().bb_sample_block(
        p(tab), tab.shape[1], table.height, table.width, cpad, n_out, p(u),
        p(v), u.numel(), p(out), _build.stream_ptr(dev))
    _build.check(err, "sample_block")
    sample_table_block_kernel.launches += 1
    return {slot: out[k] for k, slot in enumerate(table.present)}


sample_table_block_kernel.launches = 0


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


def sample_material(tables: tuple, u, v, kernels=None) -> dict:
    """Every SLOTS entry sampled at planar uv (missing slots are 0).

    ``kernels`` (``pipeline.Kernels``, or anything with ``sample_block``
    and ``sample_small``) routes as the JAX package's
    ``sample_material(use_pallas=True)``: block tables to
    ``kernels.sample_block`` (K6), quad tables of at most SMALL_ROWS rows
    to ``kernels.sample_small`` (K7), bigger ones to
    :func:`sample_table_xla`. ``kernels=None`` is its ``use_pallas=False``
    form: :func:`sample_table_block` and :func:`sample_table_xla`."""
    out = {}
    for table in tables:
        if isinstance(table, BlockTable):
            fn = sample_table_block if kernels is None \
                else kernels.sample_block
        elif (kernels is not None
              and table.height * table.width <= SMALL_ROWS):
            fn = kernels.sample_small
        else:
            fn = sample_table_xla
        out.update(fn(table, u, v))
    for slot in SLOTS:
        out.setdefault(slot, torch.zeros_like(u))
    return out
