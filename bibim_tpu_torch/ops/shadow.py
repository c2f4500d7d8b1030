"""Shadow mapping (port of ``bibim_tpu.ops.shadow``).

The shadow-casting directional light renders the scene depth-only through
the frame's raster (K1) into a reversed-Z orthographic light frustum fit to
the scene's world bounds (optionally its XY to the casters only); the map
packs into clamp-to-edge 2×2 quad rows, and each screen pixel resolves a
bilinear-weighted PCF visibility in [0, 1] (1 = lit) with one row read.
The PCF is torch ops, as the JAX package's is XLA: no kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bibim_tpu_torch import math3d as m3


class ShadowMap(NamedTuple):
    quads: torch.Tensor  # (S*S, 4) f32 — [d00, d01, d10, d11] reversed-Z
    light_vp: torch.Tensor  # (4, 4) world → light clip
    size: int


def _aabb_corners_view(vmin, vmax, view):
    one = torch.ones_like(vmin[0])
    corners = torch.stack([
        torch.stack([vmax[0] if i & 1 else vmin[0],
                     vmax[1] if i & 2 else vmin[1],
                     vmax[2] if i & 4 else vmin[2], one])
        for i in range(8)
    ])  # (8, 4)
    cv = corners @ view.T
    return cv.min(dim=0).values, cv.max(dim=0).values


def light_view_proj(light_dir, world_min, world_max, pad: float = 1.05,
                    fit_min=None, fit_max=None):
    """Orthographic light frustum fit to the scene AABB. ``light_dir`` is
    the direction the light travels. With ``fit_min``/``fit_max`` (the
    casters' AABB) the X/Y extents fit the casters only while Z spans the
    whole scene, so every receiver's depth stays comparable."""
    d = light_dir / torch.clamp(torch.linalg.norm(light_dir), min=1e-20)
    center = (world_min + world_max) * 0.5
    radius = torch.linalg.norm(world_max - world_min) * 0.5 + 1e-3
    eye = center - d * radius * 2.0
    x_up = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    y_up = torch.tensor([0.0, 1.0, 0.0], device=d.device)
    up = torch.where(torch.abs(d[1]) > 0.99, x_up, y_up)
    view = m3.look_at(eye, center, up)

    lo, hi = _aabb_corners_view(world_min, world_max, view)
    if fit_min is not None:
        lo_f, hi_f = _aabb_corners_view(fit_min, fit_max, view)
        lo = torch.cat([lo_f[:2], lo[2:]])
        hi = torch.cat([hi_f[:2], hi[2:]])
    # Expand the fit symmetrically (shrinking positive mins would clip
    # near-light geometry out of the map).
    mid = (lo + hi) * 0.5
    half = (hi - lo) * 0.5 * pad + 1e-3
    lo = mid - half
    hi = mid + half
    proj = m3.orthographic(lo[0], hi[0], lo[1], hi[1],
                           torch.clamp(lo[2], min=1e-4), hi[2])
    return m3.matmul(proj, view)


def build_shadow_map(depth_img: torch.Tensor, light_vp,
                     size: int) -> ShadowMap:
    """Light-view reversed-Z depth image → PCF quad rows (clamp-to-edge
    neighbourhoods: shadow maps do not repeat)."""
    d = depth_img
    d01 = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
    d10 = torch.cat([d[1:], d[-1:]], dim=0)
    d11 = torch.cat([d10[:, 1:], d10[:, -1:]], dim=1)
    quads = torch.stack([d, d01, d10, d11], dim=-1).reshape(size * size, 4)
    return ShadowMap(quads=quads, light_vp=light_vp, size=size)


def _light_clip(shadow: ShadowMap, world):
    """World-position planes → light clip planes (orthographic: w = 1)."""
    wx, wy, wz = world
    vp = shadow.light_vp
    return tuple(vp[r, 0] * wx + vp[r, 1] * wy + vp[r, 2] * wz + vp[r, 3]
                 for r in range(3))


def _inside_frustum(cx, cy, cz):
    """Pixels whose light clip position falls inside the map (only these
    can be occluded; everything else resolves lit)."""
    return ((cx >= -1.0) & (cx <= 1.0) & (cy >= -1.0) & (cy <= 1.0)
            & (cz >= 0.0) & (cz <= 1.0))


def shadow_factor(shadow: ShadowMap, world, bias: float = 2e-3):
    """Planar PCF visibility (1 = lit) for world-position planes
    ``world`` = (wx, wy, wz), each (NT, NPX)."""
    cx, cy, cz = _light_clip(shadow, world)
    return _pcf(shadow, cx, cy, cz, bias)


def shadow_factor_compact(shadow: ShadowMap, world, valid,
                          query_tile_cap: int, bias: float = 2e-3,
                          pair: bool = False, tile_w: int = 128):
    """:func:`shadow_factor` with the PCF row read compacted to the tiles
    whose covered pixels land inside the light frustum (at most
    ``query_tile_cap``; the rest resolve lit). Returns ``(vis, dropped
    tiles)``; a footprint bigger than the cap is a non-zero drop count.

    ``pair`` (pair_visibility, lossy): PCF at pair rate — one row read a
    vertically adjacent pixel pair, at its even member if that one is
    covered and inside the frustum or the odd one is not, else at the odd
    one; both share that visibility, and a member outside the frustum
    still resolves lit."""
    from bibim_tpu_torch.ops import fused

    cx, cy, cz = _light_clip(shadow, world)
    nt = cx.shape[0]

    def pcf(cxc, cyc, czc, vc):
        if not pair:
            return _pcf(shadow, cxc, cyc, czc, bias)
        ntc, npx = cxc.shape
        hp = npx // tile_w // 2

        def g(p):
            return p.reshape(ntc, hp, 2, tile_w)

        inside = _inside_frustum(cxc, cyc, czc)
        pref = g(inside & vc)
        use_even = pref[:, :, 0, :] | ~pref[:, :, 1, :]

        def rep(p):
            pg = g(p)
            return torch.where(use_even, pg[:, :, 0, :], pg[:, :, 1, :])

        vr = _pcf(shadow, rep(cxc), rep(cyc), rep(czc), bias)
        vis = vr[:, :, None, :].expand(ntc, hp, 2, tile_w).reshape(ntc, npx)
        return torch.where(inside, vis, torch.ones_like(vis))

    if query_tile_cap >= nt:
        return (pcf(cx, cy, cz, valid),
                torch.zeros((), dtype=torch.int32, device=cx.device))
    live = (_inside_frustum(cx, cy, cz) & valid).any(dim=1)
    ids, dropped = fused._compact_tile_list(live, query_tile_cap)
    ids = ids.long()
    vis = torch.ones_like(cx)
    # Dead slots repeat the first listed tile: idempotent under the write.
    vis[ids] = pcf(cx[ids], cy[ids], cz[ids], valid[ids])
    return vis, dropped


def _pcf(shadow: ShadowMap, cx, cy, cz, bias: float):
    """Bilinear 2×2 PCF from light clip planes (one quad-row read per
    pixel; outside-frustum pixels resolve lit)."""
    s = shadow.size
    fx = (cx * 0.5 + 0.5) * s - 0.5
    fy = (cy * 0.5 + 0.5) * s - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.clamp(x0.to(torch.int32), 0, s - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, s - 1)
    idx = y0i * s + x0i
    q = shadow.quads[idx.reshape(-1).long()].reshape(idx.shape + (4,))
    ref = cz + bias

    def lit(tap):
        return (q[..., tap] <= ref).to(torch.float32)

    top = lit(0) * (1.0 - tx) + lit(1) * tx
    bot = lit(2) * (1.0 - tx) + lit(3) * tx
    vis = top * (1.0 - ty) + bot * ty
    return torch.where(_inside_frustum(cx, cy, cz), vis,
                       torch.ones_like(vis))
