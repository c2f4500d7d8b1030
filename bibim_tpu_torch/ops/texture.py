"""Image-space texture sampling (port of ``bibim_tpu.ops.texture``): the
legacy material bindings ``MaterialTextures`` (level-0 bilinear) and
``MaterialMips`` (trilinear over a :class:`MipAtlas`).

REPEAT addressing, texel centres at +0.5, u8 texels dequantized by
× 1/255. The mip levels of one texture pack into one flat texel buffer, so
a per-pixel level is one flat gather; the LOD comes from 2×2 pixel-quad uv
differences of the (H, W, 2) uv image (the GPU derivative model). Plain
torch ops on any device: the JAX package runs these as XLA code, not as a
Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_INV255 = 1.0 / 255.0


def _wrap(i, size):
    """REPEAT addressing (a floor modulo, like ``jnp.remainder``)."""
    return torch.remainder(i, size)


def _texels(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32) * _INV255 if t.dtype == torch.uint8 else t


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-filter sample: ``tex`` (Ht, Wt, C) u8 or float, ``uv``
    (..., 2)."""
    h, w = tex.shape[0], tex.shape[1]
    x = _wrap(torch.floor(uv[..., 0] * w).to(torch.int32), w)
    y = _wrap(torch.floor(uv[..., 1] * h).to(torch.int32), h)
    return _texels(tex[y.long(), x.long()])


def _bilinear(fetch, uv, hi, wi):
    """Bilinear blend of ``fetch(yi, xi)`` at ``uv`` on an hi × wi grid
    (ints, or per-pixel int32 planes: the float sizes scale uv, the int
    sizes wrap the texel indices)."""
    h = hi.to(torch.float32) if isinstance(hi, torch.Tensor) else hi
    w = wi.to(torch.float32) if isinstance(wi, torch.Tensor) else wi
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = _wrap(x0.to(torch.int32), wi)
    y0i = _wrap(y0.to(torch.int32), hi)
    x1i = _wrap(x0i + 1, wi)
    y1i = _wrap(y0i + 1, hi)
    t00, t01 = fetch(y0i, x0i), fetch(y0i, x1i)
    t10, t11 = fetch(y1i, x0i), fetch(y1i, x1i)
    top = t00 * (1 - tx) + t01 * tx
    bot = t10 * (1 - tx) + t11 * tx
    return top * (1 - ty) + bot * ty


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with REPEAT wrap → (..., C) float32."""
    h, w = tex.shape[0], tex.shape[1]
    return _bilinear(lambda yi, xi: _texels(tex[yi.long(), xi.long()]),
                     uv, h, w)


class MipAtlas(NamedTuple):
    """Every mip level of one texture packed into one flat texel buffer."""

    texels: torch.Tensor  # (total, C)
    offsets: torch.Tensor  # (L,) int32 flat offset of each level
    heights: torch.Tensor  # (L,) int32
    widths: torch.Tensor  # (L,) int32
    num_levels: int


def build_mip_atlas(mips: list, device="cuda") -> MipAtlas:
    """Pack a mip chain of (H, W, C) arrays (level 0 first)."""
    offsets = np.zeros(len(mips), np.int32)
    total = 0
    for i, m in enumerate(mips):
        offsets[i] = total
        total += m.shape[0] * m.shape[1]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return MipAtlas(
        texels=t(np.concatenate([np.asarray(m).reshape(-1, m.shape[-1])
                                 for m in mips])),
        offsets=t(offsets),
        heights=t(np.asarray([m.shape[0] for m in mips], np.int32)),
        widths=t(np.asarray([m.shape[1] for m in mips], np.int32)),
        num_levels=len(mips))


def _sample_level_flat(atlas: MipAtlas, uv, level) -> torch.Tensor:
    """Bilinear sample at an integer per-pixel level (flat gathers)."""
    level = torch.clamp(level, 0, atlas.num_levels - 1).long()
    hi = atlas.heights[level]
    wi = atlas.widths[level]
    off = atlas.offsets[level]

    def fetch(yi, xi):
        return _texels(atlas.texels[(off + yi * wi + xi).long()])

    return _bilinear(fetch, uv, hi, wi)


def quad_uv_lod(uv: torch.Tensor, tex_h, tex_w) -> torch.Tensor:
    """Per-pixel LOD ≥ 0 from 2×2 quad differences of an (H, W, 2) uv
    image (``tex_h`` / ``tex_w``: level-0 size, ints or 0-dim tensors);
    an odd last row / column repeats its neighbour's LOD."""
    h, w = uv.shape[0], uv.shape[1]
    he, we = h - h % 2, w - w % 2
    uvq = uv[:he, :we].reshape(h // 2, 2, w // 2, 2, 2)
    dx = (uvq[:, :, :, 1] - uvq[:, :, :, 0])[:, :, :, None, :]
    dy = (uvq[:, 1] - uvq[:, 0])[:, None, :, :, :]
    shape = (h // 2, 2, w // 2, 2, 2)
    dx = dx.expand(shape).reshape(he, we, 2)
    dy = dy.expand(shape).reshape(he, we, 2)
    sx, sy = (torch.as_tensor(x, device=uv.device).to(torch.float32)
              for x in (tex_w, tex_h))

    def norm(d):
        a = d[..., 0] * sx
        b = d[..., 1] * sy
        return torch.sqrt(a * a + b * b)

    rho = torch.maximum(norm(dx), norm(dy))
    lod = torch.log2(torch.clamp(rho, min=1e-12))
    if h % 2 or w % 2:
        lod = torch.nn.functional.pad(lod[None, None], (0, w % 2, 0, h % 2),
                                      mode="replicate")[0, 0]
    return torch.clamp(lod, min=0.0)


def sample_trilinear(atlas: MipAtlas, uv: torch.Tensor,
                     lod: torch.Tensor) -> torch.Tensor:
    """Trilinear sample (bilinear at two levels, blended) at per-pixel
    ``lod``."""
    l0 = torch.floor(lod).to(torch.int32)
    frac = (lod - l0.to(torch.float32))[..., None]
    s0 = _sample_level_flat(atlas, uv, l0)
    s1 = _sample_level_flat(atlas, uv, l0 + 1)
    return s0 * (1 - frac) + s1 * frac
