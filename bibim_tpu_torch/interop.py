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

from bibim_tpu_torch.ops import ibl as ibl_ops
from bibim_tpu_torch.ops import texture as tx
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.pipeline.autotune import CapProbe
from bibim_tpu_torch.pipeline.framegraph import (
    FrameParams,
    GBufferViz,
    MaterialMips,
    MaterialTextures,
    OverlayResources,
    RenderSettings,
    ViewBlock,
)
from bibim_tpu_torch.scene.culling import HostInstances, host_instances
from bibim_tpu_torch.scene.lights import Lights
from bibim_tpu_torch.scene.scene import DrawBatch, SceneData


def tensor(x, device="cuda", dtype=None) -> torch.Tensor:
    a = np.array(np.asarray(x), copy=True)
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def _nested(x, device):
    if isinstance(x, (tuple, list)):
        return tuple(_nested(c, device) for c in x)
    return tensor(x, device)


def draw_batch(b, device="cuda") -> DrawBatch:
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


def lights(lt, device="cuda") -> Lights:
    return Lights(*(tensor(getattr(lt, f), device) for f in Lights._fields))


def scene_data(scene, device="cuda") -> SceneData:
    """Every batch and the lights; a frustum-culled scene (its batches'
    bucket-padded instance matrices) carries across the same way."""
    return SceneData(batches=tuple(draw_batch(b, device)
                                   for b in scene.batches),
                     lights=lights(scene.lights, device))


def batch_host_instances(b) -> HostInstances:
    """The host matrices and bounds the port's cull reads, from a JAX
    DrawBatch (its de-indexed positions and instance matrices)."""
    return host_instances(np.asarray(b.positions), np.asarray(b.model),
                          np.asarray(b.inv_model))


def cap_probe(p) -> CapProbe:
    """The JAX package's CapProbe (host ints) as the port's."""
    kw = {f: getattr(p, f) for f in CapProbe._fields}
    kw["span_big"] = tuple(tuple(int(x) for x in e) for e in p.span_big)
    kw["small_pair_frac"] = float(p.small_pair_frac)
    for f in CapProbe._fields:
        if f not in ("span_big", "small_pair_frac"):
            kw[f] = int(kw[f])
    return CapProbe(**kw)


def _quad_rows(q, device) -> torch.Tensor:
    q = np.asarray(q)
    if q.dtype == np.int32:
        q = np.ascontiguousarray(q).view(np.uint8)
    return tensor(q, device)


def _static(x):
    """Nested tuples of Python ints / bools (static table geometry)."""
    if isinstance(x, (tuple, list)):
        return tuple(_static(c) for c in x)
    return bool(x) if isinstance(x, (bool, np.bool_)) else int(x)


def material_tables(tables, device="cuda") -> tuple:
    """QuadTable / BlockTable / MipQuadTable / MipQuadMulti / MipBlockMulti
    tuple, static geometry as Python tuples. Quad rows the JAX package
    stores as int32 lanes (big tables) come back as their little-endian
    bytes."""
    out = []
    for t in tables:
        kind = type(t).__name__
        if kind == "BlockTable":
            out.append(tq.BlockTable(tensor(t.blocks, device), t.height,
                                     t.width, tuple(t.present)))
        elif kind == "QuadTable":
            out.append(tq.QuadTable(_quad_rows(t.quads, device), t.height,
                                    t.width, tuple(t.present)))
        elif kind in ("MipQuadTable", "MipQuadMulti"):
            out.append(getattr(tq, kind)(
                _quad_rows(t.quads, device), _static(t.heights),
                _static(t.widths), _static(t.offsets), tuple(t.present),
                bool(t.paired)))
        elif kind == "MipBlockMulti":
            out.append(tq.MipBlockMulti(
                tensor(t.blocks, device), _static(t.heights),
                _static(t.widths), _static(t.offsets), tuple(t.present),
                _static(t.last_parent)))
        else:
            raise NotImplementedError(f"material table {kind}")
    return tuple(out)


_TABLE_KINDS = ("QuadTable", "BlockTable", "MipQuadTable", "MipQuadMulti",
                "MipBlockMulti")


def mip_atlas(a, device="cuda") -> tx.MipAtlas:
    """The JAX package's ``ops.texture.MipAtlas``."""
    return tx.MipAtlas(
        texels=tensor(a.texels, device),
        offsets=tensor(a.offsets, device, torch.int32),
        heights=tensor(a.heights, device, torch.int32),
        widths=tensor(a.widths, device, torch.int32),
        num_levels=int(a.num_levels))


def materials(m, device="cuda"):
    """Any material binding ``render_frame`` takes: ``MaterialTextures``
    (its six (H, W, 4) u8 maps), ``MaterialMips`` (six MipAtlas), a tuple
    of tables (:func:`material_tables`, the single-material MipQuadTable
    binding included) or a tuple of such per-material bindings."""
    kind = type(m).__name__
    if kind == "MaterialTextures":
        return MaterialTextures(*(tensor(getattr(m, f), device)
                                  for f in MaterialTextures._fields))
    if kind == "MaterialMips":
        return MaterialMips(*(mip_atlas(getattr(m, f), device)
                              for f in MaterialMips._fields))
    if type(m[0]).__name__ in _TABLE_KINDS:
        return material_tables(m, device)
    return tuple(materials(x, device) for x in m)


def ibl(j, device="cuda"):
    """The JAX package's ``IblSH`` (analytic fits) or ``IblMaps`` (quad
    tables) → the port's ``ops.ibl`` counterpart."""
    kind = type(j).__name__
    if kind == "IblSH":
        def poly(p):
            return ibl_ops.sph_poly(np.asarray(p.coef), np.asarray(p.sg_axis),
                                    np.asarray(p.sg_amp),
                                    np.asarray(p.sg_sharp), p.degree, device)

        return ibl_ops.IblSH(poly(j.irradiance), poly(j.spec_gloss),
                             poly(j.spec_rough))
    if kind == "IblMaps":
        return ibl_ops.IblMaps(material_tables(j.irradiance, device),
                               material_tables(j.spec_gloss, device),
                               material_tables(j.spec_rough, device),
                               float(j.hdr_scale))
    raise NotImplementedError(f"IBL probe {kind}")


def overlay_resources(ov, device="cuda") -> OverlayResources:
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


def view_block(vb, device="cuda") -> ViewBlock:
    return ViewBlock(
        view=tensor(vb.view, device, torch.float32),
        proj=tensor(vb.proj, device, torch.float32),
        view_pos=tensor(vb.view_pos, device, torch.float32),
        enable_normal_map=tensor(vb.enable_normal_map, device, torch.int32),
    )


def frame_params(fp, device="cuda") -> FrameParams:
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
