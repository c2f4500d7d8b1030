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
reads these rows by index; the samplers here are the plain forms the
debug ("full") frame and the tests use.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SLOTS = (
    "alb_r", "alb_g", "alb_b",
    "nrm_x", "nrm_y", "nrm_z",
    "metallic", "roughness", "ao", "height",
)
BLOCK_B = 4
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


def sample_material(tables: tuple, u, v) -> dict:
    """Every SLOTS entry sampled at planar uv (missing slots are 0)."""
    out = {}
    for table in tables:
        if isinstance(table, BlockTable):
            out.update(sample_table_block(table, u, v))
        else:
            out.update(sample_table_xla(table, u, v))
    for slot in SLOTS:
        out.setdefault(slot, torch.zeros_like(u))
    return out
