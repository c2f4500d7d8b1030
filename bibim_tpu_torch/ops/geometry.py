"""Vertex stage (port of ``bibim_tpu.ops.geometry``).

world = Model·p, clip = ViewProj·world, normal/tangent through the normal
matrix and normalized. Two layouts:

- corner planes (:class:`PlanarSoup`, :func:`assemble_scene_planar`):
  dense (I, 3F) plane ops over the three corners concatenated, then split
  into per-corner (T,) planes — the frame's path for de-indexed batches
  (``scene.batch_from_mesh``);
- shared vertices (:class:`TriangleSoup`, :func:`assemble_scene`): (I·V,
  k) vertex arrays and (T, 3) corner ids — hand-built batches without
  corner planes, ``geometry="legacy"``, and the TBN view's face data.

Draw order is kept: later batches win equal-depth ties.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.scene.scene import DrawBatch


class TriangleSoup(NamedTuple):
    """Flattened world / clip-space vertex arrays of one frame."""

    clip: torch.Tensor  # (N,4)
    world: torch.Tensor  # (N,3)
    normal: torch.Tensor  # (N,3) unit
    tangent: torch.Tensor  # (N,3) unit
    uv: torch.Tensor  # (N,2)
    color: torch.Tensor  # (N,3)
    tris: torch.Tensor  # (T,3) int32 corner ids into the N-arrays
    mat_id: torch.Tensor  # (N,) int32 material index

    @property
    def num_triangles(self) -> int:
        return int(self.tris.shape[0])


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
    """One de-indexed batch (its ``corner_planes``) through the vertex
    stage; batches without corner planes take :func:`transform_batch`."""
    cp = batch.corner_planes
    if cp is None:
        raise ValueError("transform_batch_planar needs a de-indexed batch "
                         "with corner planes (scene.batch_from_mesh); "
                         "transform_batch takes shared-vertex batches")
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


def transform_rows(p4: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(V, 4) points through (I, R, 4) matrices → (I, V, R): the four
    products summed in order k = 0..3 (``einsum("vk,imk->ivm")``)."""
    out = p4[None, :, None, 0] * m[:, None, :, 0]
    for k in range(1, 4):
        out = out + p4[None, :, None, k] * m[:, None, :, k]
    return out


def _rows3(v3: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(V, 3) vectors through (I, 3, 3) matrices → (I, V, 3)."""
    out = v3[None, :, None, 0] * m[:, None, :, 0]
    for k in range(1, 3):
        out = out + v3[None, :, None, k] * m[:, None, :, k]
    return out


def _normalize_safe(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-20) along the last axis of size 3, the squares
    summed in order (as the corner-plane stage sums them)."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    n = torch.sqrt(x * x + y * y + z * z)
    return v * torch.reciprocal(torch.clamp(n, min=1e-20))


def transform_batch(batch: DrawBatch, view_proj: torch.Tensor):
    """One batch's V vertices by its I instances → (clip, world, normal,
    tangent, uv, color) as (I·V, k) arrays and (I·F, 3) corner ids."""
    num_i = batch.model.shape[0]
    num_v = batch.positions.shape[0]
    p4 = torch.cat([batch.positions, torch.ones_like(batch.positions[:, :1])],
                   dim=1)
    world4 = transform_rows(p4, batch.model)  # (I, V, 4)
    clip = transform_rows(world4.reshape(-1, 4), view_proj[None])[0].reshape(
        num_i, num_v, 4)
    nmat = m3.normal_matrix(batch.inv_model)  # (I,3,3)
    normal = _normalize_safe(_rows3(batch.normals, nmat))
    tangent = _normalize_safe(_rows3(batch.tangents, nmat))

    def flat(x):
        return x.reshape((num_i * num_v,) + x.shape[2:])

    def tile(a):
        return a[None].expand((num_i,) + a.shape).reshape(
            (num_i * a.shape[0],) + a.shape[1:])

    offs = (torch.arange(num_i, dtype=torch.int32,
                         device=batch.indices.device) * num_v)[:, None, None]
    tris = (batch.indices.to(torch.int32)[None] + offs).reshape(-1, 3)
    return (flat(clip), flat(world4)[:, :3], flat(normal), flat(tangent),
            tile(batch.uvs), tile(batch.colors), tris)


def assemble_scene(batches: Sequence[DrawBatch], view: torch.Tensor,
                   proj: torch.Tensor,
                   material_ids: Sequence[int] | None = None
                   ) -> TriangleSoup:
    """Transform and concatenate all batches in draw order into one
    shared-vertex soup; ``material_ids`` gives each batch's material
    index (default 0)."""
    view_proj = m3.matmul(proj, view)
    parts = [transform_batch(b, view_proj) for b in batches]
    base = 0
    tris_all, mat_all = [], []
    for bi, part in enumerate(parts):
        n = part[0].shape[0]
        tris_all.append(part[6] + base)
        base += n
        mid = 0 if material_ids is None else int(material_ids[bi])
        mat_all.append(torch.full((n,), mid, dtype=torch.int32,
                                  device=part[0].device))

    def cat(i):
        return torch.cat([p[i] for p in parts])

    return TriangleSoup(clip=cat(0), world=cat(1), normal=cat(2),
                        tangent=cat(3), uv=cat(4), color=cat(5),
                        tris=torch.cat(tris_all), mat_id=torch.cat(mat_all))
