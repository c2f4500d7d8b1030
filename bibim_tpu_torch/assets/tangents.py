"""Per-corner tangents from UV derivatives, orthogonalized against the
corner normal (a copy of the JAX package's ``assets/tangents.py``; the
aiProcess_CalcTangentSpace analog the FBX loader uses)."""

from __future__ import annotations

import numpy as np


def compute_face_tangents(positions: np.ndarray, uvs: np.ndarray,
                          indices: np.ndarray) -> np.ndarray:
    """Per-triangle tangent from UV derivatives. (T,3)."""
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    d1 = uvs[i1] - uvs[i0]
    d2 = uvs[i2] - uvs[i0]
    denom = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    f = np.where(np.abs(denom) > 1e-20,
                 1.0 / np.where(denom == 0, 1, denom), 0.0)
    t = f[:, None] * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2)
    return t.astype(np.float32)


def compute_corner_tangents(positions: np.ndarray, uvs: np.ndarray,
                            normals: np.ndarray,
                            indices: np.ndarray) -> np.ndarray:
    """Face tangent per corner, Gram-Schmidt against the corner normal,
    normalized; degenerate faces fall back to (0,-1,0)."""
    face_t = compute_face_tangents(positions, uvs, indices)
    corner_t = np.zeros((positions.shape[0], 3), np.float32)
    corner_t[indices.reshape(-1)] = np.repeat(face_t, 3, axis=0)
    n = normals
    t = corner_t - n * np.sum(corner_t * n, axis=-1, keepdims=True)
    norm = np.linalg.norm(t, axis=-1, keepdims=True)
    ok = norm[:, 0] > 1e-12
    out = np.where(ok[:, None], t / np.where(norm == 0, 1, norm),
                   np.float32([0, -1, 0]))
    return out.astype(np.float32)
