"""Vertex stage on corner planes (port of ``bibim_tpu.ops.geometry``).

world = Model·p, clip = ViewProj·world, normal/tangent through the normal
matrix and normalized — as dense (I, 3F) plane ops over the three corners
concatenated, then split into per-corner (T,) planes (:class:`PlanarSoup`).
Draw order is kept: later batches win equal-depth ties.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.scene.scene import DrawBatch


class PlanarSoup(NamedTuple):
    """Every channel is a tuple of three per-corner (T,) planes."""

    clip: tuple  # ((x0,x1,x2), (y..), (z..), (w..))
    world: tuple
    normal: tuple
    tangent: tuple
    uv: tuple  # ((u0..2), (v0..2))
    color: tuple
    mat: torch.Tensor  # (T,) f32 material id

    @property
    def num_triangles(self) -> int:
        return int(self.clip[0][0].shape[0])


def _apply_affine(rows: torch.Tensor, px, py, pz):
    """rows: (I, 4) matrix rows; p*: (F,) planes → (I, F) (w = 1)."""
    return (rows[:, 0:1] * px[None, :] + rows[:, 1:2] * py[None, :]
            + rows[:, 2:3] * pz[None, :] + rows[:, 3:4])


def transform_batch_planar(batch: DrawBatch,
                           view_proj: torch.Tensor) -> PlanarSoup:
    cp = batch.corner_planes
    if cp is None:
        raise NotImplementedError(
            "the planar pipeline needs de-indexed batches with corner planes "
            "(build them with scene.batch_from_mesh)")
    num_i = batch.model.shape[0]
    px, py, pz = cp["pos_cat"]
    num_f = px.shape[0] // 3
    nmat = m3.normal_matrix(batch.inv_model)  # (I,3,3)

    w = tuple(_apply_affine(batch.model[:, r, :], px, py, pz)
              for r in range(3))
    clip = tuple(
        view_proj[m, 0] * w[0] + view_proj[m, 1] * w[1]
        + view_proj[m, 2] * w[2] + view_proj[m, 3]
        for m in range(4)
    )

    def rot(planes3):
        return tuple(
            nmat[:, r, 0:1] * planes3[0][None, :]
            + nmat[:, r, 1:2] * planes3[1][None, :]
            + nmat[:, r, 2:3] * planes3[2][None, :]
            for r in range(3)
        )

    def unit(v3):
        inv = torch.reciprocal(torch.clamp(torch.sqrt(
            v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2]), min=1e-20))
        return tuple(v3[k] * inv for k in range(3))

    normal = unit(rot(cp["normal_cat"]))
    tangent = unit(rot(cp["tangent_cat"]))

    def corner(x, c):  # (I, 3F) → corner c's flat (I*F,) plane
        return x[:, c * num_f:(c + 1) * num_f].reshape(num_i * num_f)

    def flat(x):  # (F,) per-vertex constant → (I*F,)
        return x[None, :].expand(num_i, num_f).reshape(num_i * num_f)

    def chan_cat(group):
        return tuple(tuple(corner(g, c) for c in range(3)) for g in group)

    return PlanarSoup(
        clip=chan_cat(clip),
        world=chan_cat(w),
        normal=chan_cat(normal),
        tangent=chan_cat(tangent),
        uv=tuple(tuple(flat(cp["uv"][k][c]) for c in range(3))
                 for k in range(2)),
        color=tuple(tuple(flat(cp["color"][k][c]) for c in range(3))
                    for k in range(3)),
        mat=torch.zeros((num_i * num_f,), dtype=torch.float32,
                        device=px.device),
    )


def assemble_scene_planar(batches: Sequence[DrawBatch], view: torch.Tensor,
                          proj: torch.Tensor,
                          material_ids: Sequence[int] | None = None
                          ) -> PlanarSoup:
    """Transform and concatenate all batches in draw order."""
    view_proj = m3.matmul(proj, view)
    parts = [transform_batch_planar(b, view_proj) for b in batches]
    mats = [torch.full_like(p.mat, 0.0 if material_ids is None
                            else float(material_ids[bi]))
            for bi, p in enumerate(parts)]

    def chan(field, nk):
        return tuple(
            tuple(torch.cat([getattr(p, field)[k][c] for p in parts])
                  for c in range(3))
            for k in range(nk)
        )

    return PlanarSoup(
        clip=chan("clip", 4), world=chan("world", 3),
        normal=chan("normal", 3), tangent=chan("tangent", 3),
        uv=chan("uv", 2), color=chan("color", 3), mat=torch.cat(mats),
    )
