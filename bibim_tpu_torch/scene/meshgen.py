"""Procedural meshes the port's own scenes use: the unit ground plane and
the UV sphere (numpy; same vertex order, UVs, winding and per-face tangent
pass as ``bibim_tpu.assets.meshgen``). Kept in the port so that a frame
built from these meshes loads no module of the JAX package."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """Indexed triangle mesh: (N,3) positions/normals/tangents, (N,2) uvs,
    (F,3) int32 indices, optional (N,3) colours."""

    positions: np.ndarray
    uvs: np.ndarray
    normals: np.ndarray
    tangents: np.ndarray
    indices: np.ndarray
    colors: np.ndarray | None = None


def generate_plane_mesh() -> Mesh:
    """XZ unit plane, +Y normal, 2 triangles."""
    f32 = np.float32
    return Mesh(
        positions=np.asarray([(-0.5, 0, -0.5), (-0.5, 0, 0.5), (0.5, 0, 0.5),
                              (0.5, 0, -0.5)], f32),
        uvs=np.asarray([(0, 0), (0, 1), (1, 1), (1, 0)], f32),
        normals=np.asarray([(0, 1, 0)] * 4, f32),
        tangents=np.asarray([(1, 0, 0)] * 4, f32),
        indices=np.asarray([(0, 1, 2), (2, 3, 0)], np.int32),
    )


def generate_uv_sphere_mesh(radius: float, horizontal_division: int,
                            vertical_division: int) -> Mesh:
    """UV sphere: (V+1) rings × (H+1) columns, pole rings skip their
    degenerate triangles (2·H·(V−1) triangles), tangents rewritten per face
    from UV derivatives with the last face touching a vertex winning."""
    h_div, v_div = horizontal_division, vertical_division
    if h_div < 3 or v_div < 2:
        raise ValueError("sphere needs >=3 horizontal, >=2 vertical "
                         "divisions")
    v_idx = np.arange(v_div + 1, dtype=np.float32)
    h_idx = np.arange(h_div + 1, dtype=np.float32)
    theta = -0.5 * np.pi + np.pi * (v_idx / v_div)
    phi = 2.0 * np.pi * (h_idx / h_div)
    cos_t = np.cos(theta)[:, None]
    pos = np.stack([
        radius * cos_t * np.cos(phi)[None, :],
        np.broadcast_to(radius * np.sin(theta)[:, None],
                        (v_div + 1, h_div + 1)),
        radius * cos_t * np.sin(phi)[None, :],
    ], axis=-1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(h_idx[None, :] / h_div,
                                      v_idx[:, None] / v_div),
                  axis=-1).reshape(-1, 2)
    normals = pos / np.linalg.norm(pos, axis=-1, keepdims=True)

    ring_rad = 2.0 * np.pi * (np.arange(h_div, dtype=np.float32) / h_div)
    pole_rad = 2.0 * np.pi * ((np.arange(h_div, dtype=np.float32) + 0.5)
                              / h_div)

    def _tan(rads):
        t = np.stack([-np.sin(rads), np.zeros_like(rads), np.cos(rads)],
                     axis=-1)
        return t / np.linalg.norm(t, axis=-1, keepdims=True)

    ring_t, pole_t = _tan(ring_rad), _tan(pole_rad)
    col = np.arange(h_div + 1) % h_div
    tangents = np.tile(ring_t[col], (v_div + 1, 1)).reshape(
        v_div + 1, h_div + 1, 3)
    tangents[0] = pole_t[col]
    tangents[v_div] = pole_t[col]
    tangents = tangents.reshape(-1, 3)

    tris = []
    for v in range(v_div):
        base = (h_div + 1) * v + np.arange(h_div)
        if v < v_div - 1:
            tris.append(np.stack([base, base + h_div + 1, base + h_div + 2],
                                 axis=-1))
        if v > 0:
            tris.append(np.stack([base + h_div + 2, base + 1, base],
                                 axis=-1))
    indices = np.concatenate(tris).astype(np.int32)

    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e0 = pos[i2] - pos[i0]
    e1 = pos[i1] - pos[i0]
    duv0 = uv[i2] - uv[i0]
    duv1 = uv[i1] - uv[i0]
    f = 1.0 / (duv0[:, 0] * duv1[:, 1] - duv1[:, 0] * duv0[:, 1])
    face_t = f[:, None] * (duv1[:, 1:2] * e0 - duv0[:, 1:2] * e1)
    flat_idx = indices.reshape(-1)
    flat_t = np.repeat(face_t, 3, axis=0)
    last = np.full(pos.shape[0], -1, dtype=np.int64)
    last[flat_idx] = np.arange(flat_idx.size)
    touched = last >= 0
    tangents[touched] = flat_t[last[touched]]
    f32 = np.float32
    return Mesh(positions=pos.astype(f32), uvs=uv.astype(f32),
                normals=normals.astype(f32), tangents=tangents.astype(f32),
                indices=indices)
