"""Homogeneous triangle setup (port of ``bibim_tpu.ops.raster``).

Per pixel p = (px, py, 1): E_e(p) = A_e·px + B_e·py + C_e; inside/front ⇔
all E_e ≥ 0; depth z = zn/wn with zn, wn screen-affine. No vertex w-divide,
so near-plane-crossing ("external") triangles rasterize their visible part
without clipping and get a conservative full-screen bbox. Back faces and
degenerates are culled by det ≤ 0 (clockwise front faces, y-down).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PlanarSetup(NamedTuple):
    """Every coefficient is its own dense (T,) plane."""

    edge_a: tuple  # (a0, a1, a2)
    edge_b: tuple
    edge_c: tuple
    z_coef: tuple  # (az, bz, cz): zn = az·px + bz·py + cz
    w_coef: tuple
    bbox: tuple  # (bx0, by0, bx1, by1) int32 inclusive pixel bounds
    valid: torch.Tensor  # (T,) bool
    zub: torch.Tensor | None = None  # conservative NDC-depth upper bound


def _max3(t):
    return torch.maximum(torch.maximum(t[0], t[1]), t[2])


def _min3(t):
    return torch.minimum(torch.minimum(t[0], t[1]), t[2])


def _setup_from_corners(xh, yh, z, w, width: int, height: int) -> PlanarSetup:
    """Shared body of both setups on per-corner (T,) planes."""
    w0, w1, w2 = w
    ea = (yh[1] * w2 - yh[2] * w1, yh[2] * w0 - yh[0] * w2,
          yh[0] * w1 - yh[1] * w0)
    eb = (xh[2] * w1 - xh[1] * w2, xh[0] * w2 - xh[2] * w0,
          xh[1] * w0 - xh[0] * w1)
    ec = (xh[1] * yh[2] - xh[2] * yh[1], xh[2] * yh[0] - xh[0] * yh[2],
          xh[0] * yh[1] - xh[1] * yh[0])

    det = ec[0] * w0 + ec[1] * w1 + ec[2] * w2
    valid = (det > 0.0) & (_max3(w) > 1e-6)
    # Exact depth-range cull: all corners z < 0 or all z > w can never pass
    # 0 ≤ zn ≤ wn inside accepted coverage.
    zw_min = _min3((z[0] - w0, z[1] - w1, z[2] - w2))
    valid = valid & (_max3(z) >= 0.0) & (zw_min <= 0.0)

    def amax3(t):
        return torch.maximum(torch.maximum(t[0].abs(), t[1].abs()),
                             t[2].abs())

    max_abs = torch.maximum(amax3(ea), torch.maximum(amax3(eb), amax3(ec)))
    scale = 1.0 / torch.clamp(max_abs, min=1e-30)
    ea = tuple(e * scale for e in ea)
    eb = tuple(e * scale for e in eb)
    ec = tuple(e * scale for e in ec)

    def dot3c(e, t):
        return e[0] * t[0] + e[1] * t[1] + e[2] * t[2]

    z_coef = (dot3c(ea, z), dot3c(eb, z), dot3c(ec, z))
    w_coef = (dot3c(ea, w), dot3c(eb, w), dot3c(ec, w))

    w_ok = (w0 > 1e-6) & (w1 > 1e-6) & (w2 > 1e-6)
    inv_w = tuple(1.0 / torch.where(w[c] == 0, 1.0, w[c]) for c in range(3))
    xs = tuple(xh[c] * inv_w[c] for c in range(3))
    ys = tuple(yh[c] * inv_w[c] for c in range(3))
    bx0 = torch.where(w_ok, torch.floor(_min3(xs)), 0.0)
    bx1 = torch.where(w_ok, torch.ceil(_max3(xs)), float(width - 1))
    by0 = torch.where(w_ok, torch.floor(_min3(ys)), 0.0)
    by1 = torch.where(w_ok, torch.ceil(_max3(ys)), float(height - 1))
    on_screen = (bx1 >= 0.0) & (bx0 < width) & (by1 >= 0.0) & (by0 < height)
    valid = valid & on_screen

    def clip_i(b, hi):
        return torch.nan_to_num(torch.clamp(b, 0, hi)).to(torch.int32)

    bbox = (clip_i(bx0, width - 1), clip_i(by0, height - 1),
            clip_i(bx1, width - 1), clip_i(by1, height - 1))
    zub = torch.where(
        w_ok, torch.clamp(_max3(tuple(z[c] * inv_w[c] for c in range(3))),
                          0.0, 1.0), 1.0)
    return PlanarSetup(edge_a=ea, edge_b=eb, edge_c=ec, z_coef=z_coef,
                       w_coef=w_coef, bbox=bbox, valid=valid, zub=zub)


def triangle_setup_planar(clip: tuple, width: int,
                          height: int) -> PlanarSetup:
    """Setup from corner-planar clip coordinates ((x0,x1,x2), .., (w..))."""
    x, y, z, w = clip

    def vh(p, c, extent):
        return (p[c] * 0.5 + w[c] * 0.5) * extent

    xh = tuple(vh(x, c, width) for c in range(3))
    yh = tuple(vh(y, c, height) for c in range(3))
    return _setup_from_corners(xh, yh, z, w, width, height)


def triangle_setup(clip: torch.Tensor, tris: torch.Tensor, width: int,
                   height: int) -> PlanarSetup:
    """Setup for an indexed mesh: (V,4) clip coordinates + (T,3) corner
    indices (the gizmo's shared-vertex mesh). Same formulas as
    :func:`triangle_setup_planar`; returned in the planar layout."""
    v = clip[tris.long()]  # (T,3,4)
    corner = tuple(tuple(v[:, c, k] for c in range(3)) for k in range(4))
    x, y, z, w = corner

    def vh(p, c, extent):
        return (p[c] * 0.5 + w[c] * 0.5) * extent

    xh = tuple(vh(x, c, width) for c in range(3))
    yh = tuple(vh(y, c, height) for c in range(3))
    return _setup_from_corners(xh, yh, z, w, width, height)
