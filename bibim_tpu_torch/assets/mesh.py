"""Mesh construction helpers (a copy of the JAX package's
``assets/mesh.py``) over the port's ``scene.meshgen.Mesh``."""

from __future__ import annotations

import numpy as np

from bibim_tpu_torch.scene.meshgen import Mesh

# Reference vertex defaults: Normal=(0,0,-1), Tangent=(0,-1,0).
DEFAULT_NORMAL = (0.0, 0.0, -1.0)
DEFAULT_TANGENT = (0.0, -1.0, 0.0)


def make_mesh(positions, indices, uvs=None, normals=None, tangents=None,
              colors=None, name: str = "") -> Mesh:
    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    n = positions.shape[0]
    indices = np.asarray(indices, np.int32).reshape(-1, 3)

    def _fill(arr, default, width):
        if arr is None:
            out = np.empty((n, width), np.float32)
            out[:] = default
            return out
        return np.asarray(arr, np.float32).reshape(n, width)

    return Mesh(
        positions=positions,
        uvs=_fill(uvs, (0.0, 0.0), 2),
        normals=_fill(normals, DEFAULT_NORMAL, 3),
        tangents=_fill(tangents, DEFAULT_TANGENT, 3),
        colors=(None if colors is None
                else np.asarray(colors, np.float32).reshape(n, 3)),
        indices=indices,
        name=name,
    )
