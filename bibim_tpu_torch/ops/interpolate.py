"""Perspective-correct attribute interpolation from a visibility buffer
(port of ``bibim_tpu.ops.interpolate``): per pixel, the winning triangle's
three corner attributes blended with the barycentrics the raster stored.
"""

from __future__ import annotations

import torch

from bibim_tpu_torch.ops.raster import VisibilityBuffer


def corner_indices(vis: VisibilityBuffer, tris: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) corner vertex ids of each pixel's triangle (triangle 0's
    at misses)."""
    return tris[torch.clamp(vis.tri_id, min=0).long()]


def interpolate(vis: VisibilityBuffer, corners: torch.Tensor,
                attr: torch.Tensor) -> torch.Tensor:
    """Blend an (N, K) vertex attribute to (H, W, K) pixels."""
    a = attr[corners.long()]  # (H, W, 3, K)
    b0 = vis.bary[..., 0:1]
    b1 = vis.bary[..., 1:2]
    b2 = 1.0 - b0 - b1
    return a[..., 0, :] * b0 + a[..., 1, :] * b1 + a[..., 2, :] * b2
