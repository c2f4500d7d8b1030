"""Line-segment overlay raster (port of ``bibim_tpu.ops.lines``; the
tbn.geom analog of the TBN view).

Each segment is sampled at ``samples`` points evenly spaced in screen space
after the w-divide (hardware lines interpolate linearly there); a sample
that passes the reversed-Z GREATER_OR_EQUAL test against the scene depth
(no depth write) and the [0, 1] depth clip writes its colour. Plain torch
ops on any device: the JAX package runs these as XLA code, not as a Pallas
kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _line_params(samples: int) -> np.ndarray:
    """The sample parameters 0 … 1 as ``jnp.linspace(0, 1, samples)`` gives
    them on the JAX package's CPU backend: i · (1/(samples − 1)) in float32
    (XLA folds the division by the constant into a reciprocal multiply),
    the last exactly 1."""
    div = np.float32(samples - 1)
    t = np.arange(samples - 1, dtype=np.float32) * (np.float32(1) / div)
    return np.concatenate([t, np.ones(1, np.float32)])


def line_params(samples: int, device) -> torch.Tensor:
    return torch.as_tensor(_line_params(samples), device=device)


def rasterize_lines(p0_clip: torch.Tensor, p1_clip: torch.Tensor,
                    colors: torch.Tensor, depth: torch.Tensor,
                    image: torch.Tensor, samples: int = 48) -> torch.Tensor:
    """Draw S segments (clip-space endpoints (S, 4), colours (S, 3)) over
    ``image`` (H, W, 3) against ``depth`` (H, W); returns the new image.

    Every write of one call has its segment's colour; where samples of
    several segments land on one pixel the later write is not defined, so
    a caller that draws segments of different colours makes one call per
    colour (see ``pipeline.framegraph._composite_tbn``)."""
    height, width = depth.shape
    eps = 1e-6
    ok = (p0_clip[:, 3] > eps) & (p1_clip[:, 3] > eps)

    def to_screen(p):
        w = p[:, 3]
        inv_w = 1.0 / torch.where(w == 0, torch.ones_like(w), w)
        x = (p[:, 0] * inv_w * 0.5 + 0.5) * width
        y = (p[:, 1] * inv_w * 0.5 + 0.5) * height
        return x, y, p[:, 2] * inv_w

    x0, y0, z0 = to_screen(p0_clip)
    x1, y1, z1 = to_screen(p1_clip)
    t = line_params(samples, depth.device)[None, :]
    xs = x0[:, None] * (1 - t) + x1[:, None] * t
    ys = y0[:, None] * (1 - t) + y1[:, None] * t
    zs = z0[:, None] * (1 - t) + z1[:, None] * t
    xi = torch.floor(xs).to(torch.int32)
    yi = torch.floor(ys).to(torch.int32)
    inside = ((xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
              & ok[:, None])
    xi = torch.clamp(xi, 0, width - 1).long()
    yi = torch.clamp(yi, 0, height - 1).long()
    scene_z = depth[yi, xi]
    visible = inside & (zs >= scene_z) & (zs <= 1.0) & (zs >= 0.0)
    col = colors[:, None, :].expand(xs.shape + (3,))
    out = image.clone()
    out[yi[visible], xi[visible]] = col[visible].to(out.dtype)
    return out
