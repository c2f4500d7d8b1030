"""Scene data model (port of ``bibim_tpu.scene.scene``).

A scene is a tuple of :class:`DrawBatch` (vertex SoA + instance matrices,
de-indexed on the host) plus a :class:`Lights` SoA. ``corner_planes``
holds the corner-planar twin of the vertex data that the planar triangle
pipeline (``ops.geometry``) consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bibim_tpu_torch.scene.lights import Lights
from bibim_tpu_torch.scene.meshgen import Mesh


class DrawBatch(NamedTuple):
    """One draw call: de-indexed mesh + I instances."""

    positions: torch.Tensor  # (V,3)
    uvs: torch.Tensor  # (V,2)
    normals: torch.Tensor  # (V,3)
    tangents: torch.Tensor  # (V,3)
    colors: torch.Tensor  # (V,3)
    indices: torch.Tensor  # (F,3) int32 (an arange for de-indexed meshes)
    model: torch.Tensor  # (I,4,4)
    inv_model: torch.Tensor  # (I,4,4)
    # channel → per-channel tuple of per-corner (F,) planes ("uv", "color")
    # or of corner-concatenated (3F,) planes ("pos_cat", "normal_cat",
    # "tangent_cat"); None for hand-built shared-vertex batches.
    corner_planes: dict | None = None


class SceneData(NamedTuple):
    batches: tuple
    lights: Lights


def _planes(a: np.ndarray, nk: int, device) -> tuple:
    """(3F, k) de-indexed array → per channel, three per-corner (F,) planes."""
    return tuple(
        tuple(torch.as_tensor(np.ascontiguousarray(a[c::3, k]), device=device)
              for c in range(3))
        for k in range(nk)
    )


def _planes_cat(a: np.ndarray, nk: int, device) -> tuple:
    """(3F, k) → per channel one (3F,) plane [corner0 | corner1 | corner2]."""
    return tuple(
        torch.as_tensor(np.concatenate(
            [np.ascontiguousarray(a[c::3, k]) for c in range(3)]),
            device=device)
        for k in range(nk)
    )


def batch_from_mesh(mesh: Mesh, model: np.ndarray | None = None,
                    device="cpu") -> DrawBatch:
    """DrawBatch from a Mesh with (I,4,4) or (4,4) instance matrices.

    The mesh is de-indexed on the host (one vertex per triangle corner), so
    the scene's triangle list is a global arange and corner fetches are
    reshapes. Instance inverses are computed on the host in float64."""
    if model is None:
        model = np.eye(4, dtype=np.float32)[None]
    model = np.asarray(model, np.float32)
    if model.ndim == 2:
        model = model[None]
    inv_model = np.linalg.inv(model.astype(np.float64)).astype(np.float32)
    colors = (mesh.colors if mesh.colors is not None
              else np.ones_like(mesh.positions))
    flat = np.asarray(mesh.indices, np.int64).reshape(-1)

    def deindex(arr):
        return np.ascontiguousarray(np.asarray(arr, np.float32)[flat])

    d_pos, d_uv = deindex(mesh.positions), deindex(mesh.uvs)
    d_nrm, d_tan = deindex(mesh.normals), deindex(mesh.tangents)
    d_col = deindex(colors)

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    return DrawBatch(
        positions=t(d_pos), uvs=t(d_uv), normals=t(d_nrm),
        tangents=t(d_tan), colors=t(d_col),
        indices=t(np.arange(flat.size, dtype=np.int32).reshape(-1, 3)),
        model=t(model), inv_model=t(inv_model),
        corner_planes={
            "uv": _planes(d_uv, 2, device),
            "color": _planes(d_col, 3, device),
            "pos_cat": _planes_cat(d_pos, 3, device),
            "normal_cat": _planes_cat(d_nrm, 3, device),
            "tangent_cat": _planes_cat(d_tan, 3, device),
        },
    )
