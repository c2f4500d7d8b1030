"""Host-side instance frustum culling (port of
``bibim_tpu.scene.culling``).

The reference recomputes every instance matrix on the CPU each frame; this
host pass also drops instances whose bounds cannot meet the view frustum
before their triangles reach the card. It reads host numpy copies of the
instance matrices and the mesh bounds (:class:`HostInstances`, kept by the
scene), never the card's, and uploads only the culled list: the survivors
padded to a power-of-two bucket with zero model matrices (every vertex of a
pad collapses onto the projected origin, so its triangles have zero area
and are culled by the setup), so a moving camera changes the triangle
count only when the bucket changes.

Culling uses the camera frustum: an instance outside the view can still
cast a visible shadow, so frames with shadows should not cull.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bibim_tpu_torch.scene.scene import DrawBatch, SceneData


class HostInstances(NamedTuple):
    """Host copies of one batch's instances: (I,4,4) float32 model and
    inverse matrices, and the de-indexed mesh's local AABB."""

    model: np.ndarray
    inv_model: np.ndarray
    lo: np.ndarray  # (3,) float32
    hi: np.ndarray


def host_instances(positions: np.ndarray, model: np.ndarray,
                   inv_model: np.ndarray) -> HostInstances:
    """From the (V,3) vertex positions a batch draws (de-indexed) and its
    host instance matrices."""
    pos = np.asarray(positions, np.float32)
    return HostInstances(np.asarray(model, np.float32),
                         np.asarray(inv_model, np.float32),
                         pos.min(axis=0), pos.max(axis=0))


def _next_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def visible_instances(host: HostInstances, view_proj: np.ndarray,
                      pad: float = 1e-3) -> np.ndarray:
    """(I,) bool — False only when the instance's transformed AABB is
    certainly outside the frustum (conservative plane rejection)."""
    lo, hi = host.lo - pad, host.hi + pad
    corners = np.stack(
        [
            np.where(np.arange(8) & 1, hi[0], lo[0]),
            np.where(np.arange(8) & 2, hi[1], lo[1]),
            np.where(np.arange(8) & 4, hi[2], lo[2]),
            np.ones(8),
        ],
        axis=-1,
    )  # (8, 4)
    world = np.einsum("ck,imk->icm", corners, host.model)  # (I,8,4)
    clip = world @ np.asarray(view_proj).T  # (I,8,4)
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    out = (
        np.all(x > w, axis=1) | np.all(x < -w, axis=1)
        | np.all(y > w, axis=1) | np.all(y < -w, axis=1)
        | np.all(z > w, axis=1) | np.all(z < 0, axis=1)
        | np.all(w <= 0, axis=1)
    )
    return ~out


def cull_batch(batch: DrawBatch, host: HostInstances,
               view_proj: np.ndarray) -> DrawBatch:
    """Drop certainly-offscreen instances; the survivors, padded to a
    power-of-two bucket with zero model matrices (identity inverses),
    are uploaded to the batch's device. A batch with every instance in
    view comes back unchanged."""
    vis = visible_instances(host, view_proj)
    n = int(vis.sum())
    if n == vis.shape[0]:
        return batch
    bucket = _next_bucket(max(n, 1))
    keep = np.flatnonzero(vis)
    new_model = np.zeros((bucket, 4, 4), np.float32)
    new_inv = np.zeros((bucket, 4, 4), np.float32)
    new_model[:n] = host.model[keep]
    new_inv[:n] = host.inv_model[keep]
    new_inv[n:] = np.eye(4, dtype=np.float32)
    dev = batch.model.device
    return batch._replace(model=torch.as_tensor(new_model, device=dev),
                          inv_model=torch.as_tensor(new_inv, device=dev))


def cull_scene_instances(scene: SceneData, hosts: tuple, view: np.ndarray,
                         proj: np.ndarray) -> SceneData:
    """Frustum-cull every batch's instances for this frame's camera;
    ``hosts`` holds each batch's :class:`HostInstances` (None: not
    culled)."""
    vp = np.asarray(proj) @ np.asarray(view)
    return scene._replace(batches=tuple(
        b if h is None else cull_batch(b, h, vp)
        for b, h in zip(scene.batches, hosts)))
