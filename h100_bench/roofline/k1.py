"""K1, the raster passes of a frame (``csrc/raster.cu``): the main pass
and the gizmo's viewport.

Per pass, from the frame's own quantities: each triangle that can cover
a pixel (front facing, on screen) is a candidate, and is tested at every
pixel of its own bounding box (``COVER_OPS`` each); every covered pixel
is resolved (``RESOLVE_OPS``). Bytes: each candidate's 15 coverage
floats (3 edge, z and w planes) read once, the record channels each
distinct winning triangle's resolve needs, one 4-byte id plane at every
pixel of the pass (a miss has to be told), and the other output planes
at each covered pixel, written once. No tile or bin of any
implementation enters the count. Counted from ``chip_smoke.raster_bytes``
/ ``raster_tests``, recast on the frame's quantities.
"""

from __future__ import annotations

import torch

COVER_OPS = 25  # 3 edge planes, z and w planes, the reciprocal, the key
RESOLVE_OPS = 100  # barycentrics, depth and the blended channels
COVER_FLOATS = 15
# Record channels a winner's resolve reads, and output planes a covered
# pixel writes: the main pass (barycentrics + id 10, z / w 6, uv 6,
# normal 9, world 9; depth key, id, u, v, normal, world), the gizmo
# (barycentrics + id 10, normal 9, colour 9; id, normal, colour).
PASSES = {"main": (40, 10), "gizmo": (28, 7)}


def pass_count(p: dict, record_ch: int, out_planes: int) -> tuple:
    s, tri = p["setup"], p["tri"]
    valid = s["valid"]
    bx0, by0, bx1, by1 = (b[valid].long() for b in s["bbox"])
    box_px = int(((bx1 - bx0 + 1) * (by1 - by0 + 1)).sum())
    n_cand = int(valid.sum())
    covered = int((tri >= 0).sum())
    winners = int(torch.unique(tri[tri >= 0]).numel())
    nbytes = (n_cand * COVER_FLOATS * 4 + winners * record_ch * 4
              + p["width"] * p["height"] * 4
              + covered * (out_planes - 1) * 4)
    ops = box_px * COVER_OPS + covered * RESOLVE_OPS
    return nbytes, ops


def count(passes: dict, frame: dict) -> tuple:
    """Bytes and operations of every raster pass of one frame."""
    nbytes = ops = 0
    for name, p in passes.items():
        b, o = pass_count(p, *PASSES[name])
        nbytes += b
        ops += o
    return nbytes, ops
