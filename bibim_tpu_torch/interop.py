"""State of the JAX package → the port's types (the "weights carried
across" step).

Every function takes the JAX package's NamedTuples or dataclasses as they
come (their array leaves only need ``numpy.asarray``) and returns the
port's counterpart with tensors on ``device``. This module imports no JAX:
it reads fields by name and converts leaves through numpy, so both packages
can render bit-identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.pipeline.framegraph import (
    FrameParams,
    GBufferViz,
    OverlayResources,
    RenderSettings,
    ViewBlock,
)
from bibim_tpu_torch.scene.lights import Lights
from bibim_tpu_torch.scene.scene import DrawBatch, SceneData


def tensor(x, device="cpu", dtype=None) -> torch.Tensor:
    a = np.array(np.asarray(x), copy=True)
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def _nested(x, device):
    if isinstance(x, (tuple, list)):
        return tuple(_nested(c, device) for c in x)
    return tensor(x, device)


def draw_batch(b, device="cpu") -> DrawBatch:
    """DrawBatch with its corner planes (the per-corner "uv"/"color" planes
    and the corner-concatenated "pos_cat"/"normal_cat"/"tangent_cat")."""
    cp = None
    if b.corner_planes is not None:
        keys = ("uv", "color", "pos_cat", "normal_cat", "tangent_cat")
        cp = {k: _nested(b.corner_planes[k], device) for k in keys}
    return DrawBatch(
        positions=tensor(b.positions, device), uvs=tensor(b.uvs, device),
        normals=tensor(b.normals, device), tangents=tensor(b.tangents, device),
        colors=tensor(b.colors, device), indices=tensor(b.indices, device),
        model=tensor(b.model, device), inv_model=tensor(b.inv_model, device),
        corner_planes=cp,
    )


def lights(lt, device="cpu") -> Lights:
    return Lights(*(tensor(getattr(lt, f), device) for f in Lights._fields))


def scene_data(scene, device="cpu") -> SceneData:
    return SceneData(batches=tuple(draw_batch(b, device)
                                   for b in scene.batches),
                     lights=lights(scene.lights, device))


def material_tables(tables, device="cpu") -> tuple:
    """QuadTable/BlockTable tuple. Quad rows the JAX package stores as
    int32 lanes (big tables) come back as their little-endian bytes."""
    out = []
    for t in tables:
        kind = type(t).__name__
        if kind == "BlockTable":
            out.append(tq.BlockTable(tensor(t.blocks, device), t.height,
                                     t.width, tuple(t.present)))
        elif kind == "QuadTable":
            q = np.asarray(t.quads)
            if q.dtype == np.int32:
                q = np.ascontiguousarray(q).view(np.uint8)
            out.append(tq.QuadTable(tensor(q, device), t.height, t.width,
                                    tuple(t.present)))
        else:
            raise NotImplementedError(f"material table {kind}")
    return tuple(out)


def overlay_resources(ov, device="cpu") -> OverlayResources:
    def opt(x, dtype=None):
        return None if x is None else tensor(x, device, dtype)

    return OverlayResources(
        sphere_positions=tensor(ov.sphere_positions, device),
        sphere_tris=tensor(ov.sphere_tris, device, torch.int32),
        gizmo_positions=opt(ov.gizmo_positions),
        gizmo_normals=opt(ov.gizmo_normals),
        gizmo_colors=opt(ov.gizmo_colors),
        gizmo_tris=opt(ov.gizmo_tris, torch.int32),
    )


def view_block(vb, device="cpu") -> ViewBlock:
    return ViewBlock(
        view=tensor(vb.view, device, torch.float32),
        proj=tensor(vb.proj, device, torch.float32),
        view_pos=tensor(vb.view_pos, device, torch.float32),
        enable_normal_map=tensor(vb.enable_normal_map, device, torch.int32),
    )


def frame_params(fp, device="cpu") -> FrameParams:
    return FrameParams(
        enable_tone_mapping=tensor(fp.enable_tone_mapping, device,
                                   torch.int32),
        exposure=tensor(fp.exposure, device, torch.float32),
    )


def render_settings(s) -> RenderSettings:
    """Field-for-field copy; every field keeps its value, so settings the
    port does not support still raise in ``render_frame``."""
    kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    kw["gbuffer_viz"] = GBufferViz(int(kw["gbuffer_viz"]))
    return RenderSettings(**kw)
