"""The frame function (port of ``bibim_tpu.pipeline.framegraph``).

Stages of :func:`render_frame`:

1. the vertex stage: corner planes for de-indexed batches
   (``ops.geometry.assemble_scene_planar``), shared-vertex (T, 3) arrays
   for hand-built batches or ``geometry="legacy"``
   (``assemble_scene``); triangle setup and the record table;
2. binning (pair sort K3) and raster + resolve (K1) of the main pass;
3. optional live-tile compaction of the shading stage (``live_tile_cap``;
   not with the image-space bindings or the TBN view);
4. with ``enable_shadows``: the light-view depth pass (K3 + K1 on the
   shadow map's grid, depth plane only) and the screen-side PCF
   visibility of the shadow-casting light (``ops.shadow``);
5. shading, either
   - ``shading="flat"``: the raster's colour Lambert-lit in view space
     (``shade_flat_planar``), no material and no compaction; or
   - deferred (``deferred=True``) without IBL or anisotropic taps, on a
     binding K2 samples: the sampled shade (K2) — materials (block, quad,
     mip-block and material-routed small groups), normal map, fp16
     G-buffer, GGX with the visibility plane; with ``pair_sampling`` the
     block tables sample at group rate on the tiles where that is exact
     (:func:`_sampled_ldr`: escape flags, a clean and an exact K2 pass,
     scattered back by slot), or everywhere with ``pair_lossy``; or
   - deferred otherwise: the G-buffer planes sampled through the
     block-table (K6), small-table (K7) and mip-block (K8) samplers — N
     times at ``aniso_taps`` N, averaged — or the image-space samplers
     (``ops.texture``) of ``MaterialTextures`` / ``MaterialMips``, then
     the split-sum IBL ambient (``ops.ibl``) and the G-buffer shade (K5),
     or for a G-buffer view the raw planes as HDR; or
   - forward (``deferred=False``, :func:`_forward_hdr`): no G-buffer and
     no fp16 round trip of its planes; K2 at ``quantize=False`` where the
     deferred frame would take K2, else the sampled planes and K5 (with
     the IBL ambient from the same planes); a G-buffer view shows cleared
     planes;
   then the fp16 HDR round trip and the exposure tone map (the kernels'
   epilogue, or torch ops);
6. scatter-back, light spheres through the overlay composite (K4, depth
   tested against the scene's keys), the in-frame HUD text (K4 against a
   cleared key, ``hud=``), the TBN lines (``ops.lines``, ``show_tbn``),
   the corner gizmo (K1 in its own viewport), sRGB encode and u8.

The sharded frame (``parallel.tile_shard``) runs the main pass, the
shading and the light spheres band by band (``band=``).

The main pass takes the reference's raster schedule variants: early-z
(K9, every pass), the group window (K10) and fine subtiles (K11);
``merged_coverage`` is accepted and has no counterpart. The XLA fallback
raster (``raster="xla"``) is not ported and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, NamedTuple

import numpy as np
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops import shadow as sh
from bibim_tpu_torch.ops import sort as sort_ops
from bibim_tpu_torch.ops import texture as tx
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.geometry import (
    PlanarSoup,
    TriangleSoup,
    assemble_scene,
    assemble_scene_planar,
    transform_rows,
)
from bibim_tpu_torch.ops.ibl import ibl_ambient
from bibim_tpu_torch.ops.lines import rasterize_lines
from bibim_tpu_torch.ops.raster import triangle_setup, triangle_setup_planar
from bibim_tpu_torch.ops.shading import (
    hdr_tail,
    q16,
    sampled_groups_supported,
    shade_sampled,
    shade_sampled_plain,
    shade_tonemap,
    shade_tonemap_plain,
)
from bibim_tpu_torch.ops.shading_planar import (
    apply_normal_map,
    shade_flat_planar,
    shade_pbr_planar,
)
from bibim_tpu_torch.ops.tonemap import srgb_encode, to_u8
from bibim_tpu_torch.scene.lights import Lights
from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
from bibim_tpu_torch.scene.scene import SceneData
from bibim_tpu_torch.utils import profiling
from bibim_tpu_torch.utils.profiling import stage_scope
from bibim_tpu_torch.utils.validation import (
    check_frame_output,
    validation_active,
)


class GBufferViz(IntEnum):
    POSITION = 0
    NORMAL = 1
    ALBEDO = 2
    MRHA = 3
    MATERIAL_INDEX = 4
    RENDERED_SCENE = 5


class ViewBlock(NamedTuple):
    view: torch.Tensor  # (4,4)
    proj: torch.Tensor  # (4,4)
    view_pos: torch.Tensor  # (3,)
    enable_normal_map: torch.Tensor  # 0-dim int32


class FrameParams(NamedTuple):
    enable_tone_mapping: torch.Tensor  # 0-dim int32
    exposure: torch.Tensor  # 0-dim float32


class MaterialTextures(NamedTuple):
    """One material's six level-0 maps, (H, W, 4) uint8 each: the
    image-space binding, sampled bilinear (``ops.texture``)."""

    albedo: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ao: torch.Tensor
    normal: torch.Tensor
    height: torch.Tensor


class MaterialMips(NamedTuple):
    """One material's six maps as ``ops.texture.MipAtlas`` mip chains:
    the image-space binding, sampled trilinear at the pixel quad's LOD."""

    albedo: tx.MipAtlas
    metallic: tx.MipAtlas
    roughness: tx.MipAtlas
    ao: tx.MipAtlas
    normal: tx.MipAtlas
    height: tx.MipAtlas


class OverlayResources(NamedTuple):
    """Light-sphere mesh and gizmo mesh (gizmo fields None when the gizmo
    mesh is not available; ``show_gizmo`` then raises)."""

    sphere_positions: torch.Tensor  # (Vs,3)
    sphere_tris: torch.Tensor  # (Fs,3) int32
    gizmo_positions: torch.Tensor | None = None
    gizmo_normals: torch.Tensor | None = None
    gizmo_colors: torch.Tensor | None = None
    gizmo_tris: torch.Tensor | None = None


@dataclass(frozen=True)
class RenderSettings:
    """The JAX package's RenderSettings, same fields and defaults. Fields
    outside this port's slice must keep their defaults (see
    :func:`check_supported`); ``xla_cap`` sizes the JAX package's XLA
    fallback raster, which the port does not have, and has no effect."""

    width: int = 1280
    height: int = 720
    deferred: bool = True
    shading: str = "pbr"
    gbuffer_viz: GBufferViz = GBufferViz.RENDERED_SCENE
    quantize_fp16: bool = True
    show_lights: bool = True
    show_gizmo: bool = True
    show_tbn: bool = False
    show_hud: bool = False
    srgb_output: bool = True
    raster: str = "auto"
    geometry: str = "auto"
    tile_h: int = 8
    tile_w: int = 128
    max_candidates: int = 320
    raster_passes: int = 1
    shadow_passes: int | None = None
    shadow_candidates: int | None = None
    overlay_candidates: int = 384
    overlay_overflow_cap: int = 512
    overlay_max_tiles: int = 512
    overflow_cap: int = 64
    span_cap: int = 16
    span_mid_cap: int | None = None
    xla_cap: int = 512
    pair_budget: int = 262144
    live_tile_cap: int | None = None
    raster_tile_cap: int | None = None
    dense_tile_cap: int | None = None
    group_pair_cap: int | None = None
    fine_bins: bool = False
    # The reference's merged coverage schedule has no counterpart on the
    # GPU (ops/fused.py raster_fused); the field stays so that settings
    # derive as the JAX package's, and dense_cap_candidates reads it.
    merged_coverage: bool = False
    sequential_tris: bool = True
    batch_material_ids: tuple | None = None
    gizmo_extent: int = 100
    tbn_length: float = 0.05
    outputs: str = "full"
    enable_shadows: bool = False
    shadow_light: int = 0
    shadow_size: int = 1024
    shadow_bias: float = 2e-3
    shadow_tile_cap: int | None = None
    shadow_query_tile_cap: int | None = None
    shadow_fit_batches: tuple | None = None
    enable_ibl: bool = False
    aniso_taps: int = 1
    pair_sampling: int = 0
    pair_visibility: bool = False
    sample_route_caps: tuple | None = None
    pair_lossy: bool = False
    early_z: bool = False

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)


class Kernels(NamedTuple):
    """The kernel entry points the frame calls."""

    raster: Callable  # K1
    overlay: Callable  # K4
    sort: Callable  # K3
    shade: Callable  # K2
    shade_gbuffer: Callable  # K5
    # K6: (BlockTable, u, v[, pair_rows=, valid=, tile_w=]) → slot planes
    sample_block: Callable
    # K7: (quads, idx, tx, ty, present) → slot planes
    sample_small: Callable
    # K8: (MipBlockMulti, mat_id, u, v, tile_h, tile_w) → slot planes
    sample_mip_block: Callable
    raster_earlyz: Callable  # K9
    raster_gw: Callable  # K10
    raster_fine: Callable  # K11
    raster_tail: Callable  # K1's tail (passes ≥ 1)


# The kernel wrappers (CUDA kernels for CUDA tensors) ...
KERNELS = Kernels(fused.raster_tiles, fused.overlay_tiles,
                  sort_ops.sort_keys, shade_sampled, shade_tonemap,
                  tq.sample_table_block_kernel, tq.sample_rows_small,
                  tq.sample_mip_block_kernel, fused.raster_tiles_earlyz,
                  fused.raster_tiles_gw, fused.raster_tiles_fine,
                  fused.raster_tiles_tail)
# ... and their plain PyTorch versions on any device (reference renders).
PLAIN = Kernels(fused.raster_tiles_plain, fused.overlay_tiles_plain,
                sort_ops.sort_keys_plain, shade_sampled_plain,
                shade_tonemap_plain, tq.sample_table_block,
                tq.sample_rows_small_plain, tq.sample_mip_block,
                fused.raster_tiles_earlyz_plain, fused.raster_tiles_gw_plain,
                fused.raster_tiles_fine_plain, fused.raster_tiles_tail_plain)

_TABLES = (tq.QuadTable, tq.BlockTable)
_MIP_TABLES = (tq.MipBlockMulti, tq.MipQuadMulti)
_IMAGE_BINDINGS = (MaterialTextures, MaterialMips)


def _one_binding(m) -> bool:
    """One material's binding (or merged mip groups): MaterialTextures,
    MaterialMips, or a tuple of QuadTable / BlockTable, or of mip groups
    (MipQuadTable, MipBlockMulti, MipQuadMulti)."""
    if isinstance(m, _IMAGE_BINDINGS):
        return True
    mips = (tq.MipQuadTable,) + _MIP_TABLES
    return isinstance(m, tuple) and bool(m) and (
        all(isinstance(t, _TABLES) for t in m)
        or all(isinstance(t, mips) for t in m))


def _per_material(m) -> bool:
    """A tuple of one-material bindings, chosen per pixel by the winning
    triangle's batch material id."""
    return (isinstance(m, (tuple, list)) and not isinstance(m, _IMAGE_BINDINGS)
            and bool(m) and not _one_binding(m)
            and all(_one_binding(x) and not isinstance(x[0], _MIP_TABLES)
                    for x in m))


def check_supported(settings: RenderSettings, materials) -> None:
    """Raise NotImplementedError for the XLA fallback raster, which the
    port does not have, and for values no frame takes (the JAX package
    fails on them too)."""
    s = settings
    flat = s.shading == "flat"
    checks = [
        (s.shading not in ("pbr", "flat"), f"shading={s.shading!r}"),
        (s.pair_sampling not in (0, 1, 2),
         f"pair_sampling={s.pair_sampling}"),
        (s.raster not in ("auto", "pallas"),
         f"raster={s.raster!r} (the XLA fallback raster)"),
        (s.geometry not in ("auto", "planar", "legacy"),
         f"geometry={s.geometry!r}"),
        (s.outputs not in ("image", "image+diag", "full"),
         f"outputs={s.outputs!r}"),
    ]
    bad = [msg for cond, msg in checks if cond]
    if not flat and not (_one_binding(materials)
                         or _per_material(materials)):
        bad.append("materials other than one material's binding "
                   "(MaterialTextures, MaterialMips, a tuple of QuadTable / "
                   "BlockTable or of mip tables) or a tuple of such "
                   "bindings")
    if bad:
        raise NotImplementedError(
            "not in the ported frame: " + ", ".join(bad))


def _planar_materials(m) -> bool:
    """True where the binding samples (NT, NPX) planes shape-agnostically
    (tables); the image-space bindings sample (H, W) images and cannot
    shade compacted tiles."""
    if isinstance(m, _IMAGE_BINDINGS):
        return False
    if isinstance(m, (tuple, list)) and m:
        if isinstance(m[0], (tq.MipQuadTable,) + _TABLES + _MIP_TABLES):
            return True
        return all(_planar_materials(x) for x in m)
    return False


def _prunable_fields(settings: RenderSettings) -> tuple:
    """Raster output planes the production frame never reads: none for
    "full", a G-buffer view or the TBN view (it reads depth); all but
    colour and normal for a flat frame; the material-id plane only
    without per-batch material ids."""
    if (settings.outputs == "full" or settings.show_tbn
            or settings.gbuffer_viz != GBufferViz.RENDERED_SCENE):
        return ()
    if settings.shading == "flat":  # colour and normal only
        keep = ("idf", "nx", "ny", "nz", "cr", "cg", "cb")
        return tuple(f for f in fused._OUT_FIELDS if f not in keep)
    drop = ("depth", "b0", "b1", "cr", "cg", "cb")
    return drop if settings.batch_material_ids is not None \
        else drop + ("matf",)


def _raster(rec, setup, width, height, settings: RenderSettings,
            kernels: Kernels, cap=None, init_zkey=None, overflow_cap=None,
            passes=None, main_pass=False, span_cap=None, drop_fields=None,
            tile_cap=None, band_y0: int = 0):
    """``tile_cap``: the pass-0 tile compaction of a pass that is not the
    main one (the main pass takes ``settings.raster_tile_cap``). Early-z
    applies to every pass (shadow and gizmo too), the group window and
    fine bins to the main pass only. ``band_y0``: the first frame row of
    a band's main pass (``ops.fused.raster_fused``)."""
    if passes is None:
        passes = settings.raster_passes if cap is None else 1
    return fused.raster_fused(
        rec, setup, width, height, tile_h=settings.tile_h,
        tile_w=settings.tile_w,
        max_candidates=cap or settings.max_candidates,
        overflow_cap=overflow_cap or settings.overflow_cap,
        span_cap=span_cap or settings.span_cap, init_zkey=init_zkey,
        pair_budget=settings.pair_budget, passes=passes,
        raster_tile_cap=settings.raster_tile_cap if main_pass else tile_cap,
        span_mid_cap=settings.span_mid_cap if main_pass else None,
        dense_tile_cap=settings.dense_tile_cap if main_pass else None,
        group_pair_cap=settings.group_pair_cap if main_pass else None,
        drop_fields=(drop_fields if drop_fields is not None
                     else (_prunable_fields(settings) if main_pass else ())),
        fine_bins=settings.fine_bins and main_pass,
        earlyz=settings.early_z, band_y0=band_y0,
        raster=kernels.raster, raster_earlyz=kernels.raster_earlyz,
        raster_gw=kernels.raster_gw, raster_fine=kernels.raster_fine,
        raster_tail=kernels.raster_tail, sort=kernels.sort,
    )


def _untile(plane, settings: RenderSettings):
    return fused.untile(plane, settings.width, settings.height,
                        settings.tiles_x, settings.tile_h, settings.tile_w)


def _compact_ids(mask: torch.Tensor, k: int, sentinel: int):
    """Compact a (NT,) mask to k ascending slot ids; dead slots get
    ``sentinel``. Returns (ids (k,), overflow count)."""
    nt = mask.shape[0]
    k = min(int(k), nt)
    iota = torch.arange(nt, dtype=torch.int32, device=mask.device)
    neg = torch.where(mask, -iota, torch.full_like(iota, -(1 << 30)))
    top = torch.topk(neg, k).values
    ids = torch.where(top > -(1 << 30), -top, torch.full_like(top, sentinel))
    over = torch.clamp(mask.sum(dtype=torch.int32) - k, min=0)
    return ids.long(), over


def _effective_pair(materials, settings: RenderSettings) -> int:
    """The pair level the sampled shade runs: mip bindings sample per
    pixel (their LOD comes from screen-space uv differences)."""
    pair = int(settings.pair_sampling)
    if pair and any(isinstance(t, _MIP_TABLES) for t in materials):
        pair = 0
    return pair


def _routes(materials, settings: RenderSettings) -> bool:
    """True where the sampled shade routes tiles between a group-rate and
    an exact pass (pair sampling on a block table, not lossy)."""
    return (isinstance(materials, tuple) and not settings.pair_lossy
            and any(isinstance(t, tq.BlockTable) for t in materials)
            and _effective_pair(materials, settings) > 0)


def _escape_flags(materials, px, pair: int, tile_w: int) -> torch.Tensor:
    """(NT,) tiles where a covered pixel escapes its group's window in any
    block table (``texture_quad.escape_tiles``)."""
    u, v = px.uv
    valid = px.tri_id >= 0
    flags = None
    for t in materials:
        if isinstance(t, tq.BlockTable):
            f = tq.escape_tiles(t, u, v, valid, pair, tile_w)
            flags = f if flags is None else flags | f
    return flags


def _route_slots(flags: torch.Tensor, q_cap: int, e_cap: int):
    """The router's slot partition: clean tiles (no escape) to the
    group-rate pass up to ``q_cap`` (the clean tiles beyond it to the
    exact pass), the rest to the exact pass up to ``e_cap``; sentinel
    slots at NT. Returns (clean ids, exact ids, exact-pass overflow)."""
    nt = flags.shape[0]
    q_cap, e_cap = min(int(q_cap), nt), min(int(e_cap), nt)
    clean = ~flags
    rank = torch.cumsum(clean.to(torch.int32), 0) - 1
    over_q = clean & (rank >= q_cap)
    clean_ids, _ = _compact_ids(clean & ~over_q, q_cap, nt)
    esc_ids, esc_over = _compact_ids(flags | over_q, e_cap, nt)
    return clean_ids, esc_ids, esc_over


def _map_pixels(px: fused.FusedPixels, fn) -> fused.FusedPixels:
    def go(x):
        if isinstance(x, tuple):
            return tuple(go(c) for c in x)
        return fn(x)

    return fused.FusedPixels(*(go(x) for x in px))


def _tile_diag(dropped, device) -> fused.BinDiag:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return fused.BinDiag(z, z, z, dropped.to(torch.int32))


def _slot_rows(p: torch.Tensor, ids, fill=0) -> torch.Tensor:
    """Tiles ``ids`` of a per-tile plane; the sentinel id NT reads
    ``fill``."""
    return torch.cat([p, torch.full_like(p[:1], fill)])[ids].contiguous()


def _slot_pixels(px: fused.FusedPixels, ids) -> fused.FusedPixels:
    """The pixels' tiles ``ids``; the sentinel id NT reads a dead tile
    (tri_id -1, every other plane 0)."""
    return _map_pixels(px, lambda p: _slot_rows(
        p, ids, -1 if p is px.tri_id else 0))


def _tile(img: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    return fused.tile_plane(img, settings.tiles_x, settings.tiles_y,
                            settings.tile_h, settings.tile_w)


def _sample_image_binding(mats, px, settings: RenderSettings) -> dict:
    """MaterialTextures (bilinear) / MaterialMips (trilinear at the pixel
    quad's LOD) sampled on the (H, W, 2) uv image, back to planes."""
    u, v = px.uv
    uv = torch.stack([_untile(u, settings), _untile(v, settings)], dim=-1)
    if isinstance(mats, MaterialMips):
        def tap(atlas):
            lod = tx.quad_uv_lod(uv, atlas.heights[0], atlas.widths[0])
            return tx.sample_trilinear(atlas, uv, lod)
    else:
        def tap(tex):
            return tx.sample_bilinear(tex, uv)

    alb = tap(mats.albedo)
    nrm = tap(mats.normal)
    out = {"alb_r": alb[..., 0], "alb_g": alb[..., 1], "alb_b": alb[..., 2],
           "nrm_x": nrm[..., 0], "nrm_y": nrm[..., 1], "nrm_z": nrm[..., 2],
           "metallic": tap(mats.metallic)[..., 0],
           "roughness": tap(mats.roughness)[..., 0],
           "ao": tap(mats.ao)[..., 0], "height": tap(mats.height)[..., 0]}
    return {k: _tile(img, settings) for k, img in out.items()}


def _sample_one_material(mats, px, settings: RenderSettings,
                         kernels: Kernels | None) -> dict:
    """One material's binding sampled at the pixels' uv → slot planes:
    tables through ``kernels``' K6 / K7 (or the plain XLA-order samplers
    with None; block tables at group rate under ``pair_lossy``), one
    material's mip tables through K8 / K7 / the quad oracle, the
    image-space bindings through ``ops.texture``."""
    if isinstance(mats, _IMAGE_BINDINGS):
        return _sample_image_binding(mats, px, settings)
    u, v = px.uv
    if all(isinstance(t, _TABLES) for t in mats):
        # Group-rate block sampling here only in the lossy mode: this path
        # does not route tiles.
        return tq.sample_material(
            mats, u, v, kernels,
            pair_rows=settings.pair_sampling if settings.pair_lossy else 0,
            valid=px.tri_id >= 0, tile_w=settings.tile_w)
    return tq.sample_material_mips_multi(mats, None, u, v, settings.tile_h,
                                         settings.tile_w, kernels)


def _sample_materials(materials, px, settings: RenderSettings,
                      kernels: Kernels | None) -> dict:
    """Every slot plane of the binding at the pixels' uv. ``aniso_taps``
    N > 1: the mean of N samples at uv + t·(du, dv) along the pixel's
    major uv axis (``tq.aniso_uv_steps``), t = (i + ½)/N − ½, summed in
    tap order, then scaled by 1/N. Merged mip groups route per pixel by
    the material-id plane; a tuple of one-material bindings selects per
    pixel by it."""
    if settings.aniso_taps > 1:
        n = settings.aniso_taps
        u, v = px.uv
        du, dv = tq.aniso_uv_steps(u, v, settings.tile_h, settings.tile_w)
        s1 = dataclasses.replace(settings, aniso_taps=1)

        def f32(x):  # the JAX package's weakly typed Python scalars
            return torch.tensor(x, dtype=torch.float32, device=u.device)

        acc = None
        for i in range(n):
            t = f32((i + 0.5) / n - 0.5)
            tap = _sample_materials(
                materials, px._replace(uv=(u + t * du, v + t * dv)), s1,
                kernels)
            acc = tap if acc is None else {k: acc[k] + tap[k] for k in acc}
        inv = f32(1.0 / n)
        return {k: acc[k] * inv for k in acc}
    if isinstance(materials[0], _MIP_TABLES):
        u, v = px.uv
        return tq.sample_material_mips_multi(
            materials, px.mat_id, u, v, settings.tile_h, settings.tile_w,
            kernels)
    if not _per_material(materials):
        return _sample_one_material(materials, px, settings, kernels)
    out = None
    for mi, mat in enumerate(materials):
        smp = _sample_one_material(mat, px, settings, kernels)
        if out is None:
            out = smp
        else:
            sel = px.mat_id == mi
            out = {k: torch.where(sel, smp[k], out[k]) for k in out}
    return out


def _materialize_gbuffer_planes(px, materials, view_block,
                                settings: RenderSettings,
                                kernels: Kernels | None = None):
    """G-buffer planes: material samples (:func:`_sample_materials`
    through ``kernels``' samplers, or the plain XLA-order samplers with
    None) + normal map + mask, and the fp16 round trip of the deferred
    frame's RGBA16F attachments (the forward frame shades full-precision
    samples)."""
    valid = px.tri_id >= 0
    slots = _sample_materials(materials, px, settings, kernels)
    albedo = (slots["alb_r"], slots["alb_g"], slots["alb_b"])
    nmap = (slots["nrm_x"], slots["nrm_y"], slots["nrm_z"])
    normal = apply_normal_map(px.normal, px.tangent, nmap,
                              view_block.enable_normal_map)
    zero = torch.zeros_like(px.depth)
    quant = settings.quantize_fp16 and settings.deferred

    def mq(ch):
        ch = torch.where(valid, ch, zero)
        return q16(ch) if quant else ch

    g_pos = tuple(mq(c) for c in px.world)
    g_nrm = tuple(mq(c) for c in normal)
    g_alb = tuple(mq(c) for c in albedo)
    g_mrah = tuple(mq(slots[k]) for k in ("metallic", "roughness", "ao",
                                          "height"))
    return g_pos, g_nrm, g_alb, g_mrah, valid


def _vis_plane(light_vis, settings: RenderSettings):
    return light_vis[settings.shadow_light] if light_vis else None


def _pbr_hdr(g_pos, g_nrm, g_alb, g_mrah, valid, lights, view_block,
             light_vis=None, ambient=None):
    """Deferred lighting on G-buffer planes → masked HDR (plain chain)."""
    hdr3 = shade_pbr_planar(g_pos, g_nrm, g_alb, g_mrah[0], g_mrah[1],
                            g_mrah[2], lights, view_block.view_pos,
                            light_vis=light_vis, ambient=ambient)
    zero = torch.zeros_like(g_mrah[0])
    return tuple(torch.where(valid, c, zero) for c in hdr3)


def _pbr_ldr_fused(g_pos, g_nrm, g_alb, g_mrah, valid, lights, view_block,
                   frame_params, settings: RenderSettings, kernels: Kernels,
                   light_vis=None, ambient=None):
    """Deferred lighting through the G-buffer shade (K5) with the fp16 HDR
    round trip and tone map as its epilogue → LDR planes."""
    return kernels.shade_gbuffer(
        g_pos, g_nrm, g_alb, g_mrah[0], g_mrah[1], g_mrah[2], valid, lights,
        view_block.view_pos, frame_params.enable_tone_mapping,
        frame_params.exposure, vis_plane=_vis_plane(light_vis, settings),
        vis_light=settings.shadow_light, ambient=ambient,
        quantize=settings.quantize_fp16, tonemap=True)


# The shadow raster reads only the depth plane (and idf, always emitted).
_SHADOW_DROP = tuple(f for f in fused._OUT_FIELDS
                     if f not in ("depth", "idf"))


def _fit_slices(scene: SceneData, settings: RenderSettings, rows):
    """(start, end) slices of the ``settings.shadow_fit_batches`` batches
    in the concatenation of ``rows(batch)`` rows per batch and instance
    (None: the fit covers the whole scene)."""
    if settings.shadow_fit_batches is None:
        return None
    out = []
    r0 = 0
    for bi, b in enumerate(scene.batches):
        r1 = r0 + int(b.model.shape[0]) * rows(b)
        if bi in settings.shadow_fit_batches:
            out.append((r0, r1))
        r0 = r1
    return tuple(out)


def _shadow_fit_ranges(scene: SceneData, settings: RenderSettings):
    """Triangle-plane slices of the caster batches (planar soup)."""
    return _fit_slices(scene, settings, lambda b: int(b.indices.shape[0]))


def _shadow_fit_rows(scene: SceneData, settings: RenderSettings):
    """Vertex-row slices of the caster batches (shared-vertex soup)."""
    return _fit_slices(scene, settings, lambda b: int(b.positions.shape[0]))


def _points(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 3) points through one 4×4 matrix → (N, 4) (w = 1)."""
    p4 = torch.cat([p, torch.ones_like(p[:, :1])], dim=1)
    return transform_rows(p4, m[None])[0]


def _shadow_map_from_soup(soup: TriangleSoup, lights: Lights,
                          settings: RenderSettings, kernels: Kernels,
                          fit_ranges=None):
    """:func:`_shadow_map_planar` for a shared-vertex soup (``fit_ranges``:
    vertex-row slices of the casters): the light-space vertices, setup
    and records of the (T, 3) mesh, the depth pass on K1."""
    size = settings.shadow_size
    d = lights.dir[settings.shadow_light]
    wmin = soup.world.min(dim=0).values
    wmax = soup.world.max(dim=0).values
    fmin = fmax = None
    if fit_ranges:
        rows = torch.cat([soup.world[s:e] for (s, e) in fit_ranges])
        fmin, fmax = rows.min(dim=0).values, rows.max(dim=0).values
    lvp = sh.light_view_proj(d, wmin, wmax, fit_min=fmin, fit_max=fmax)
    clip_l = _points(soup.world, lvp)
    seq = settings.sequential_tris
    setup_l = triangle_setup(clip_l, soup.tris, size, size, sequential=seq)
    z3 = torch.zeros_like(soup.world)
    rec_l = fused.build_record_table(setup_l, soup.tris, z3[:, :2], z3, z3,
                                     z3, z3, sequential=seq)
    px_l, _, sh_diag = _raster(
        rec_l, setup_l, size, size, settings, kernels,
        cap=settings.shadow_candidates,
        passes=settings.shadow_passes or settings.raster_passes,
        drop_fields=_SHADOW_DROP, tile_cap=settings.shadow_tile_cap)
    tiles_x = -(-size // settings.tile_w)
    depth_img = fused.untile(px_l.depth, size, size, tiles_x,
                             settings.tile_h, settings.tile_w)
    return sh.build_shadow_map(depth_img, lvp, size), sh_diag


def _world_bounds_planar(world, ranges=None):
    """(min, max) (3,) bounds of corner-planar world planes, optionally
    over (start, end) triangle slices."""
    sl = ranges if ranges else ((0, None),)

    def bound(k, fn):
        return fn(torch.stack([fn(world[k][c][s:e]) for c in range(3)
                               for (s, e) in sl]))

    return (torch.stack([bound(k, torch.min) for k in range(3)]),
            torch.stack([bound(k, torch.max) for k in range(3)]))


def _light_clip_planar(psoup: PlanarSoup, lights: Lights,
                       settings: RenderSettings, fit_ranges=None):
    """The shadow-casting light's frustum (fit to the scene, its XY to
    ``fit_ranges`` where given) and the corner planes in its clip space.
    Returns (light view-projection, clip planes)."""
    d = lights.dir[settings.shadow_light]
    wmin, wmax = _world_bounds_planar(psoup.world)
    fmin = fmax = None
    if fit_ranges:
        fmin, fmax = _world_bounds_planar(psoup.world, fit_ranges)
    lvp = sh.light_view_proj(d, wmin, wmax, fit_min=fmin, fit_max=fmax)
    w = psoup.world
    clip_l = tuple(
        tuple(lvp[m, 0] * w[0][c] + lvp[m, 1] * w[1][c]
              + lvp[m, 2] * w[2][c] + lvp[m, 3] for c in range(3))
        for m in range(4))
    return lvp, clip_l


def _shadow_map_planar(psoup: PlanarSoup, lights: Lights,
                       settings: RenderSettings, kernels: Kernels,
                       fit_ranges=None):
    """Depth-only light pass through the frame's raster (K1, every plane
    but depth dropped) → (ShadowMap, BinDiag of the pass)."""
    size = settings.shadow_size
    lvp, clip_l = _light_clip_planar(psoup, lights, settings, fit_ranges)
    w = psoup.world
    setup_l = triangle_setup_planar(clip_l, size, size)
    zero = torch.zeros_like(w[0][0])
    z3 = ((zero,) * 3,) * 3
    zero_soup = PlanarSoup(clip=clip_l, world=z3, normal=z3, tangent=z3,
                           uv=((zero,) * 3,) * 2, color=z3, mat=zero)
    rec_l = fused.build_record_table_planar(setup_l, zero_soup)
    px_l, _, sh_diag = _raster(
        rec_l, setup_l, size, size, settings, kernels,
        cap=settings.shadow_candidates,
        passes=settings.shadow_passes or settings.raster_passes,
        drop_fields=_SHADOW_DROP, tile_cap=settings.shadow_tile_cap)
    tiles_x = -(-size // settings.tile_w)
    depth_img = fused.untile(px_l.depth, size, size, tiles_x,
                             settings.tile_h, settings.tile_w)
    return sh.build_shadow_map(depth_img, lvp, size), sh_diag


def _pcf_vis(smap: sh.ShadowMap, px, settings: RenderSettings, sh_diag):
    """Screen-side PCF visibility; compacted to the frustum footprint's
    tiles when ``shadow_query_tile_cap`` is set (dropped footprint tiles
    add to the shadow pass's BinDiag), at pair rate with
    ``pair_visibility``."""
    if (settings.shadow_query_tile_cap is not None
            or settings.pair_visibility):
        cap = settings.shadow_query_tile_cap
        vis, dropped = sh.shadow_factor_compact(
            smap, px.world, px.tri_id >= 0,
            px.tri_id.shape[0] if cap is None else cap,
            settings.shadow_bias, pair=settings.pair_visibility,
            tile_w=settings.tile_w)
        return vis, sh_diag._replace(
            dropped_tiles=sh_diag.dropped_tiles + dropped)
    return sh.shadow_factor(smap, px.world, settings.shadow_bias), sh_diag


def _shadow_map_any(soup, scene: SceneData, settings: RenderSettings,
                    kernels: Kernels):
    """The shadow map of the shadow-casting light and its pass's BinDiag,
    from the main pass's planar soup or its (T, 3) soup."""
    if isinstance(soup, PlanarSoup):
        return _shadow_map_planar(soup, scene.lights, settings, kernels,
                                  _shadow_fit_ranges(scene, settings))
    return _shadow_map_from_soup(soup, scene.lights, settings, kernels,
                                 _shadow_fit_rows(scene, settings))


def _light_sphere_planar_soup(lights: Lights, overlay: OverlayResources,
                              view_proj) -> PlanarSoup:
    """Instanced light spheres (translate(light.pos)), flat light colour,
    as corner planes."""
    vs = overlay.sphere_positions
    tris = overlay.sphere_tris.long()
    num_l = lights.num_lights
    f = tris.shape[0]
    corner_idx = tris.T.reshape(-1)
    pcat = tuple(vs[:, k][corner_idx] for k in range(3))
    wcat = tuple(pcat[k][None, :] + lights.pos[:, k, None] for k in range(3))
    ccat = tuple(view_proj[m, 0] * wcat[0] + view_proj[m, 1] * wcat[1]
                 + view_proj[m, 2] * wcat[2] + view_proj[m, 3]
                 for m in range(4))

    def corners(xcat):
        return tuple(xcat[:, c * f:(c + 1) * f].reshape(-1)
                     for c in range(3))

    zeros = torch.zeros((num_l * f,), dtype=torch.float32, device=vs.device)
    zt = (zeros, zeros, zeros)
    colc = tuple(lights.color[:, ch, None].expand(num_l, f).reshape(-1)
                 for ch in range(3))
    return PlanarSoup(
        clip=tuple(corners(c) for c in ccat),
        world=tuple(corners(w) for w in wcat),
        normal=(zt, zt, zt), tangent=(zt, zt, zt), uv=(zt, zt),
        color=tuple((c, c, c) for c in colc), mat=zeros,
    )


def _composite_light_spheres(ldr, zkey, lights: Lights,
                             overlay: OverlayResources, view_proj,
                             settings: RenderSettings, kernels: Kernels,
                             band=None):
    """The light spheres into the (3, NT, NPX) LDR planes ``ldr`` (in
    place on the card), depth-tested against the scene's keys ``zkey``.
    ``band`` = (band height, first frame row): the planes and keys are a
    horizontal band's (the sharded frame); the overlay composite indexes
    them by band tile, so the sphere records are rebased to band rows
    (``ops.fused.shift_record_table_y``). Returns (ldr', diag)."""
    height, y0 = (settings.height, None) if band is None else band
    soup = _light_sphere_planar_soup(lights, overlay, view_proj)
    setup = triangle_setup_planar(soup.clip, settings.width, settings.height,
                                  band_y0=y0, band_height=height)
    rec = fused.build_record_table_planar(setup, soup)
    if band is not None:
        rec = fused.shift_record_table_y(rec, y0)
    return fused.composite_overlay(
        rec, setup, ldr, zkey, settings.width, height,
        tile_h=settings.tile_h, tile_w=settings.tile_w,
        max_candidates=settings.overlay_candidates,
        overflow_cap=settings.overlay_overflow_cap, span_cap=32,
        max_tiles=min(settings.overlay_max_tiles,
                      settings.tiles_x * -(-height // settings.tile_h)),
        span_mid_cap=max(256, rec.shape[0] // 4),
        overlay=kernels.overlay, sort=kernels.sort,
    )


def _hud_geometry(hud, device):
    """HUD cell quads as an indexed mesh (JAX framegraph._composite_hud):
    corners tl/tr/br/bl of each cell, a mask of 0 collapsing the quad to
    its centre (zero area, culled by triangle setup), z = w = 1; the
    triangles [0, 1, 3] of every cell, then [1, 2, 3]. Returns (clip
    (4·cells, 4), tris (2·cells, 3) int32)."""
    geom, mask = hud

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    cx, cy, m = t(geom.cx), t(geom.cy), t(mask)
    n = cx.shape[0]
    offx = t([-1.0, 1.0, 1.0, -1.0]) * geom.dx
    offy = t([-1.0, -1.0, 1.0, 1.0]) * geom.dy
    x = (cx[:, None] + offx[None, :] * m[:, None]).reshape(-1)
    y = (cy[:, None] + offy[None, :] * m[:, None]).reshape(-1)
    ones = torch.ones_like(x)
    clip = torch.stack([x, y, ones, ones], dim=-1)
    base = (torch.arange(n, dtype=torch.int32, device=device) * 4)[:, None]
    corners = torch.tensor([[0, 1, 3], [1, 2, 3]], dtype=torch.int32,
                           device=device)
    tris = torch.cat([base + corners[0], base + corners[1]], dim=0)
    return clip, tris


def _composite_hud(ldr, hud, settings: RenderSettings, kernels: Kernels):
    """Burn the HUD text cells (``hud`` = (HudGeometry, mask), host.hud)
    into the (3, NT, NPX) LDR planes ``ldr`` (in place on the card): white
    cell quads drawn depth-free (reversed-Z 1.0 against a cleared key:
    no key plane is built) through the overlay composite (K4), with the
    JAX package's capacities (cells span at most 4 tiles; one 8×128 tile
    holds up to ~440 triangles of a 2×-scale line). Returns (ldr',
    diag)."""
    dev = ldr.device
    clip, tris = _hud_geometry(hud, dev)
    w, h = settings.width, settings.height
    setup = triangle_setup(clip, tris, w, h)
    zeros = torch.zeros((clip.shape[0], 3), dtype=torch.float32, device=dev)
    rec = fused.build_record_table(setup, tris, zeros[:, :2], zeros, zeros,
                                   zeros, torch.ones_like(zeros))
    nt = settings.tiles_x * settings.tiles_y
    return fused.composite_overlay(
        rec, setup, ldr, None, w, h, tile_h=settings.tile_h,
        tile_w=settings.tile_w, max_candidates=512, overflow_cap=64,
        span_cap=4, max_tiles=min(64, nt), overlay=kernels.overlay,
        sort=kernels.sort)


def _gizmo_clip(view, proj, overlay: OverlayResources):
    """Gizmo vertices → clip through the gizmo viewport camera (main-view
    rotation, camera 27 back along the look vector, 30° fov)."""
    rot = view[:3, :3]
    look = view[2, :3]
    view_pos = look * -27.0
    trans = -(rot @ view_pos)
    gz_view = view.clone()
    gz_view[:3, 3] = trans
    # torch.tensor copies the scalar to the card synchronously (pageable).
    # Counted; test_host_syncs_count_every_sync holds the counts to torch's
    # sync debug mode on the card.
    d = 1.0 / torch.tan(torch.tensor(0.261799, dtype=torch.float32,
                                     device=view.device))
    if view.device.type == "cuda":
        profiling.count("host_syncs")
    gz_proj = proj.clone()
    gz_proj[0, 0] = d
    gz_proj[1, 1] = -d
    vp = m3.matmul(gz_proj, gz_view)
    pos = overlay.gizmo_positions
    p4 = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return p4 @ vp.T, gz_view


def _render_gizmo(view, proj, overlay: OverlayResources,
                  settings: RenderSettings, kernels: Kernels):
    """The orientation gizmo in its own ``gizmo_extent``² viewport with a
    cleared depth buffer, Lambert-lit in view space."""
    ext = settings.gizmo_extent
    clip, gz_view = _gizmo_clip(view, proj, overlay)
    gz = RenderSettings(width=ext, height=ext, tile_h=settings.tile_h,
                        tile_w=settings.tile_w,
                        max_candidates=settings.overlay_candidates,
                        overflow_cap=settings.overflow_cap,
                        span_cap=settings.span_cap)
    tris = overlay.gizmo_tris
    setup = triangle_setup(clip, tris, ext, ext)
    zeros2 = torch.zeros((clip.shape[0], 2), dtype=torch.float32,
                         device=clip.device)
    rec = fused.build_record_table(
        setup, tris, zeros2, overlay.gizmo_normals,
        torch.zeros_like(overlay.gizmo_normals), overlay.gizmo_positions,
        overlay.gizmo_colors)
    px, _, gz_diag = _raster(rec, setup, ext, ext, gz, kernels,
                             cap=settings.overlay_candidates)
    gz_rgb = shade_flat_planar(px.color, px.normal, gz_view[:3, :3])

    def region(c):
        return fused.untile(c, ext, ext, gz.tiles_x, gz.tile_h, gz.tile_w)

    return region(px.tri_id >= 0), tuple(region(c) for c in gz_rgb), gz_diag


def _gizmo_into(ldr3_img, hit, rgb, width: int, y0: int = 0):
    """The gizmo patch (``hit``, ``rgb``: :func:`_render_gizmo`'s
    ext² images) over the frame's top-right corner, into the rows of
    ``ldr3_img`` that start at frame row ``y0`` (a band's rows in the
    sharded frame)."""
    rows = ldr3_img[0].shape[0]
    ext = hit.shape[0]
    r1 = min(ext, y0 + rows)
    if r1 <= y0:
        return ldr3_img
    ex = min(ext, width)
    x0 = width - ex
    out = []
    for c in range(3):
        img = ldr3_img[c].clone()
        img[0:r1 - y0, x0:] = torch.where(hit[y0:r1, :ex],
                                          rgb[c][y0:r1, :ex],
                                          img[0:r1 - y0, x0:])
        out.append(img)
    return tuple(out)


def _composite_gizmo(ldr3_img, view, proj, overlay: OverlayResources,
                     settings: RenderSettings, kernels: Kernels):
    hit, rgb, gz_diag = _render_gizmo(view, proj, overlay, settings, kernels)
    return _gizmo_into(ldr3_img, hit, rgb, settings.width), gz_diag


def _as_planes(ldr3) -> torch.Tensor:
    """Three LDR planes as one (3, NT, NPX) tensor: the shading kernel's
    own output where they are its views (or the tensor itself), else
    their stack."""
    if isinstance(ldr3, torch.Tensor):
        return ldr3
    base = ldr3[0]._base
    own = (base is not None and base.dim() == 3 and base.shape[0] == 3
           and base.shape[1:] == ldr3[0].shape
           and all(c._base is base and c.data_ptr() == base[i].data_ptr()
                   for i, c in enumerate(ldr3)))
    return base if own else torch.stack(ldr3)


def _scatter_slots(planes: torch.Tensor, ids, nt: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """(3, K, NPX) ``planes`` of slots ``ids`` (sentinel NT) into a zeroed
    (3, NT + 1, NPX) buffer, or into ``out``; returns the buffer."""
    if out is None:
        out = planes.new_zeros((3, nt + 1, planes.shape[2]))
    out[:, ids] = planes
    return out


def _ldr_planes(ldr3, compact_ids, nt_full: int) -> torch.Tensor:
    """The shaded LDR planes as one (3, NT, NPX) tensor that the overlay
    composites write in place, and nothing else reads
    (:func:`_as_planes`); with live-tile compaction (``compact_ids``,
    dead slots at ``nt_full``), scattered into the first NT tiles of a
    zeroed (3, NT + 1, NPX) buffer."""
    planes = _as_planes(ldr3)
    if compact_ids is None:
        return planes
    return _scatter_slots(planes, compact_ids, nt_full)[:, :nt_full]


def _sampled_ldr(px, materials, lights: Lights, view_block: ViewBlock,
                 frame_params: FrameParams, settings: RenderSettings,
                 kernels: Kernels, light_vis, diags: list,
                 gbuffer: bool = True):
    """LDR planes of the sampled shade (K2 with the fp16 + tone-map tail);
    ``gbuffer``: the deferred frame's fp16 G-buffer round trip in the
    kernel (the forward frame shades the raw samples, ``quantize=False``).

    With ``pair_sampling`` (and a block table, not lossy) the tiles route:
    those with no escaping pixel (:func:`_escape_flags`) run K2 at the
    pair level, the rest K2 per pixel, each pass on its compacted slots
    (``sample_route_caps`` = (clean cap, exact cap); clean tiles past
    their cap run exact, exact tiles past theirs add to
    ``BinDiag.dropped_tiles``), and the LDR planes scatter back by slot
    (the tail is per pixel, so this equals scattering HDR). The frame is
    then bit-equal to pair level 0. ``pair_lossy``: one unrouted pass at
    the pair level."""
    pair = _effective_pair(materials, settings)

    def shade(p, lv, level):
        return kernels.shade(
            materials, p.uv[0], p.uv[1], p.world, p.normal, p.tangent,
            p.tri_id >= 0, lights, view_block.view_pos,
            view_block.enable_normal_map,
            quantize=settings.quantize_fp16 and gbuffer,
            vis_plane=_vis_plane(lv, settings),
            vis_light=settings.shadow_light, mat_id=p.mat_id,
            tile_h=settings.tile_h, tile_w=settings.tile_w,
            quantize_hdr=settings.quantize_fp16, tonemap=True,
            enable_tone_mapping=frame_params.enable_tone_mapping,
            exposure=frame_params.exposure, pair=level)

    if not _routes(materials, settings):
        return shade(px, light_vis, pair)
    flags = _escape_flags(materials, px, pair, settings.tile_w)
    nt = flags.shape[0]
    q_cap, e_cap = settings.sample_route_caps or (nt, nt)
    clean_ids, esc_ids, esc_over = _route_slots(flags, q_cap, e_cap)
    diags.append(_tile_diag(esc_over, flags.device))
    out = None
    for ids, level in ((clean_ids, pair), (esc_ids, 0)):
        lv = None if light_vis is None else {
            k: _slot_rows(p, ids) for k, p in light_vis.items()}
        ldr = shade(_slot_pixels(px, ids), lv, level)
        out = _scatter_slots(_as_planes(ldr), ids, nt, out)
    return out[:, :nt]


def _forward_hdr(px, materials, lights: Lights, view_block: ViewBlock,
                 frame_params: FrameParams, settings: RenderSettings,
                 kernels: Kernels, light_vis, ibl, production: bool,
                 diags: list):
    """Forward lighting: shade the sampled material and the interpolated
    attributes directly, no G-buffer and no fp16 round trip of its planes.
    Returns (masked HDR planes, None) for "full" (the plain chain), or
    (None, LDR planes) for the production frame: K2 at ``quantize=False``
    with the fp16 + tone-map tail where the deferred frame would run K2
    (no IBL, one tap, a binding K2 samples), else the sampled planes
    (K6 / K7 / K8, or the image-space samplers) and K5 with the same
    tail, the IBL ambient taken from those planes."""
    ibl_on = settings.enable_ibl and ibl is not None
    if (production and not ibl_on and settings.aniso_taps == 1
            and sampled_groups_supported(materials)):
        return None, _sampled_ldr(px, materials, lights, view_block,
                                  frame_params, settings, kernels,
                                  light_vis, diags, gbuffer=False)
    sampling = kernels if production else None
    valid = px.tri_id >= 0
    slots = _sample_materials(materials, px, settings, sampling)
    albedo = (slots["alb_r"], slots["alb_g"], slots["alb_b"])
    nmap = (slots["nrm_x"], slots["nrm_y"], slots["nrm_z"])
    normal = apply_normal_map(px.normal, px.tangent, nmap,
                              view_block.enable_normal_map)
    met, rough, ao = slots["metallic"], slots["roughness"], slots["ao"]
    zero = torch.zeros_like(met)
    ambient = None
    if ibl_on:
        view_dir = tuple(view_block.view_pos[c] - px.world[c]
                         for c in range(3))
        ambient = ibl_ambient(ibl, normal, view_dir, albedo, met, rough, ao,
                              sampling)
        ambient = tuple(torch.where(valid, a, zero) for a in ambient)
    if production:
        return None, kernels.shade_gbuffer(
            px.world, normal, albedo, met, rough, ao, valid, lights,
            view_block.view_pos, frame_params.enable_tone_mapping,
            frame_params.exposure, vis_plane=_vis_plane(light_vis, settings),
            vis_light=settings.shadow_light, ambient=ambient,
            quantize=settings.quantize_fp16, tonemap=True)
    hdr3 = shade_pbr_planar(px.world, normal, albedo, met, rough, ao, lights,
                            view_block.view_pos, light_vis=light_vis,
                            ambient=ambient)
    return tuple(torch.where(valid, c, zero) for c in hdr3), None


def _composite_tbn(ldr3_img, soup: TriangleSoup, depth_img, view_proj,
                   settings: RenderSettings):
    """The TBN view (tbn.vert/geom/frag): per face, segments from the
    centroid along the face-averaged tangent (red), bitangent N × T
    (green) and normal (blue), ``tbn_length`` long, depth-tested against
    ``depth_img`` without depth write. The three colours draw in three
    calls, in that order, so blue wins where they overlap."""
    tris = soup.tris.long()
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32,
                         device=soup.world.device)

    def mean3(a):  # (T, 3, k) → (T, k): the corner sum times 1/3
        return (a[:, 0] + a[:, 1] + a[:, 2]) * third

    centroid = mean3(soup.world[tris])

    def face_avg(attr):
        vv = mean3(attr[tris])
        x, y, z = vv[:, 0:1], vv[:, 1:2], vv[:, 2:3]
        n = torch.sqrt(x * x + y * y + z * z)
        return vv / torch.clamp(n, min=1e-20)

    bitangent = torch.linalg.cross(soup.normal, soup.tangent, dim=-1)
    length = settings.tbn_length
    ends = (((1.0, 0.0, 0.0), centroid + face_avg(soup.tangent) * length),
            ((0.0, 1.0, 0.0), centroid + face_avg(bitangent) * length),
            ((0.0, 0.0, 1.0), centroid + face_avg(soup.normal) * length))
    ldr = torch.stack(ldr3_img, dim=-1)
    c_clip = _points(centroid, view_proj)
    for color, end in ends:
        col = torch.tensor(color, dtype=torch.float32,
                           device=ldr.device).expand(centroid.shape)
        ldr = rasterize_lines(c_clip, _points(end, view_proj), col,
                              depth_img, ldr)
    return tuple(ldr[..., c] for c in range(3))


def _use_planar(scene: SceneData, settings: RenderSettings) -> bool:
    """The corner-planar vertex stage runs for de-indexed batches (those
    with corner planes, ``sequential_tris``); hand-built shared-vertex
    batches and ``geometry="legacy"`` take the (T, 3) path."""
    if settings.geometry == "legacy":
        return False
    ok = settings.sequential_tris and all(
        b.corner_planes is not None for b in scene.batches)
    if settings.geometry == "planar" and not ok:
        raise ValueError("geometry='planar' needs de-indexed batches with "
                         "corner_planes (build via batch_from_mesh)")
    return ok


def _assemble(scene: SceneData, view_block: ViewBlock,
              settings: RenderSettings):
    """The vertex stage: corner planes (PlanarSoup) for de-indexed
    batches, else the (T, 3) TriangleSoup (:func:`_use_planar`)."""
    if _use_planar(scene, settings):
        return assemble_scene_planar(scene.batches, view_block.view,
                                     view_block.proj,
                                     settings.batch_material_ids)
    return assemble_scene(scene.batches, view_block.view, view_block.proj,
                          settings.batch_material_ids)


def _main_setup(scene: SceneData, view_block: ViewBlock,
                settings: RenderSettings, band=None):
    """The main pass's vertex stage and triangle setup; ``band`` = (band
    height, first frame row) sets up a horizontal band (bounding boxes in
    band rows). Returns (soup, setup): a PlanarSoup, or the TriangleSoup
    of the (T, 3) path."""
    w, h = settings.width, settings.height
    band_h, y0 = (None, None) if band is None else band
    soup = _assemble(scene, view_block, settings)
    if isinstance(soup, PlanarSoup):
        return soup, triangle_setup_planar(soup.clip, w, h, band_y0=y0,
                                           band_height=band_h)
    return soup, triangle_setup(soup.clip, soup.tris, w, h, band_y0=y0,
                                band_height=band_h,
                                sequential=settings.sequential_tris)


def _assemble_and_raster(scene: SceneData, view_block: ViewBlock,
                         settings: RenderSettings, kernels: Kernels,
                         band=None):
    """The main pass: vertex stage, setup, records, raster; with ``band``
    (:func:`_main_setup`) the raster bins and covers the band's tiles and
    rasterizes them at the frame's pixel centres (the records stay in
    frame coordinates), so each pixel is the single frame's. Returns
    (pixels, zkey, diag, soup)."""
    with stage_scope("frame.geometry"):
        soup, setup = _main_setup(scene, view_block, settings, band)
        if isinstance(soup, PlanarSoup):
            rec = fused.build_record_table_planar(setup, soup)
        else:
            rec = fused.build_record_table(
                setup, soup.tris, soup.uv, soup.normal, soup.tangent,
                soup.world, soup.color, soup.mat_id,
                sequential=settings.sequential_tris)
    h, y0 = (settings.height, 0) if band is None else band
    with stage_scope("frame.raster"):
        px, zkey, diag = _raster(rec, setup, settings.width, h, settings,
                                 kernels, main_pass=True, band_y0=y0)
    return px, zkey, diag, soup


def _shade(px, materials, lights: Lights, view_block: ViewBlock,
           frame_params: FrameParams, settings: RenderSettings,
           kernels: Kernels, light_vis, ibl, diags: list):
    """Shading of the raster's pixels (stage 5 of :func:`render_frame`;
    the sharded frame's bands run it too). Returns (LDR planes, HDR
    planes or None where a kernel tone maps in its epilogue, the
    G-buffer images of a "full" deferred frame)."""
    valid = px.tri_id >= 0
    flat = settings.shading == "flat"
    viz = settings.gbuffer_viz != GBufferViz.RENDERED_SCENE
    hdr3 = None
    gb = {}
    ldr3 = None
    production = settings.outputs != "full"
    if flat:
        # Unlit flat colour, Lambert in view space (gizmo.frag's model):
        # BASELINE config 1 and colour-only meshes.
        hdr3 = shade_flat_planar(px.color, px.normal, view_block.view[:3, :3])
        zero = torch.zeros_like(hdr3[0])
        hdr3 = tuple(torch.where(valid, c, zero) for c in hdr3)
    elif not settings.deferred:
        # Forward lighting: no G-buffer exists, so a G-buffer view shows
        # the cleared attachments.
        if viz:
            zero = torch.zeros_like(px.depth)
            hdr3 = (zero, zero, zero)
        else:
            hdr3, ldr3 = _forward_hdr(px, materials, lights,
                                      view_block, frame_params, settings,
                                      kernels, light_vis, ibl, production,
                                      diags)
    elif (production and not settings.enable_ibl and not viz
            and settings.aniso_taps == 1
            and sampled_groups_supported(materials)):
        ldr3 = _sampled_ldr(px, materials, lights, view_block,
                            frame_params, settings, kernels, light_vis,
                            diags)
    else:
        # The production frame samples through K6/K7/K8 and shades on K5;
        # "full" keeps the plain chain.
        sampling = kernels if production else None
        g_pos, g_nrm, g_alb, g_mrah, valid = _materialize_gbuffer_planes(
            px, materials, view_block, settings, sampling)
        zero = torch.zeros_like(px.depth)
        ambient = None
        if settings.enable_ibl and ibl is not None and not viz:
            view_dir = tuple(view_block.view_pos[c] - g_pos[c]
                             for c in range(3))
            ambient = ibl_ambient(ibl, g_nrm, view_dir, g_alb, g_mrah[0],
                                  g_mrah[1], g_mrah[2], sampling)
            ambient = tuple(torch.where(valid, a, zero) for a in ambient)
        if viz:
            # buffer_visualize.frag: the raw G-buffer rgb is the HDR
            # target (no lighting); MATERIAL_INDEX is gbuffer.frag's
            # placeholder.
            hdr3 = {
                GBufferViz.POSITION: g_pos, GBufferViz.NORMAL: g_nrm,
                GBufferViz.ALBEDO: g_alb, GBufferViz.MRHA: g_mrah[:3],
                GBufferViz.MATERIAL_INDEX: (torch.where(valid, 1.0, 0.0),
                                            zero, zero),
            }[settings.gbuffer_viz]
        elif production:
            ldr3 = _pbr_ldr_fused(g_pos, g_nrm, g_alb, g_mrah, valid,
                                  lights, view_block, frame_params,
                                  settings, kernels, light_vis, ambient)
        else:
            hdr3 = _pbr_hdr(g_pos, g_nrm, g_alb, g_mrah, valid,
                            lights, view_block, light_vis, ambient)
        if not production:
            def img3(planes):
                return torch.stack([_untile(c, settings) for c in planes],
                                   -1)

            gb = {
                "position": img3(g_pos), "normal": img3(g_nrm),
                "albedo": img3(g_alb), "mrah": img3(g_mrah),
                "matindex": img3((torch.where(valid, 1.0, 0.0), zero, zero)),
            }
    if ldr3 is None:
        ldr3 = hdr_tail(hdr3, settings.quantize_fp16, True,
                        frame_params.enable_tone_mapping,
                        frame_params.exposure)

    return ldr3, hdr3, gb


def render_frame(scene: SceneData, view_block: ViewBlock,
                 frame_params: FrameParams, materials,
                 overlay: OverlayResources | None, settings: RenderSettings,
                 ibl=None, kernels: Kernels = KERNELS, hud=None):
    """Render one frame.

    ``materials``: one material's binding (a tuple of QuadTable /
    BlockTable, of mip tables, or ``MaterialTextures`` /
    ``MaterialMips``) or a tuple of such bindings chosen by
    ``settings.batch_material_ids``. ``settings.outputs``: "image" →
    {'image': (H,W,3) u8}; "image+diag" adds the summed BinDiag of every
    raster pass; "full" shades through the plain chain (XLA-order
    samplers, planar GGX) and adds ldr/hdr/depth/tri_id/gbuffer images
    (``gbuffer`` empty on the forward path, which has none). ``ibl``
    (``ops.ibl.IblSH`` or ``IblMaps``) is the light probe
    ``settings.enable_ibl`` shades with.
    ``kernels`` selects the kernel entry points (default: the wrappers;
    :data:`PLAIN` renders a reference frame with the plain versions on any
    device). ``hud`` = (``host.hud.HudGeometry``, its text mask) is the
    text ``settings.show_hud`` burns in; without it the frame has no
    HUD.

    The host's work is recorded (``utils.profiling``) as the span
    ``framegraph.frame`` holding five stages in turn: ``frame.geometry``,
    ``frame.raster``, ``frame.shade``, ``frame.overlay``,
    ``frame.output``."""
    with stage_scope("framegraph.frame"):
        return _render_frame(scene, view_block, frame_params, materials,
                             overlay, settings, ibl, kernels, hud)


def _render_frame(scene: SceneData, view_block: ViewBlock,
                  frame_params: FrameParams, materials,
                  overlay: OverlayResources | None, settings: RenderSettings,
                  ibl, kernels: Kernels, hud):
    """:func:`render_frame`'s work in its five stages: geometry and raster
    (:func:`_assemble_and_raster`), shade, overlay, output."""
    check_supported(settings, materials)
    if settings.show_gizmo and overlay is not None \
            and overlay.gizmo_tris is None:
        raise ValueError("show_gizmo needs OverlayResources with a gizmo "
                         "mesh")
    dev = view_block.view.device

    px, zkey, diag, soup = _assemble_and_raster(scene, view_block,
                                                settings, kernels)
    diags = [diag]

    with stage_scope("frame.shade"):
        nt_full = px.tri_id.shape[0]
        compact_ids = None
        flat = settings.shading == "flat"
        viz = settings.gbuffer_viz != GBufferViz.RENDERED_SCENE
        # Not for the image-space bindings, which sample (H, W) images.
        can_compact = (settings.live_tile_cap is not None
                       and settings.live_tile_cap < nt_full and not viz
                       and not settings.show_tbn and not flat
                       and _planar_materials(materials))
        if (settings.outputs == "full" and settings.sample_route_caps
                and not flat and _routes(materials, settings)):
            # Debug frames shade through the plain chain but still report
            # whether the production router's caps would overflow: escape
            # tiles past the exact cap, with the clean tiles past the clean
            # cap that fall through to it.
            flags = _escape_flags(materials, px,
                                  _effective_pair(materials, settings),
                                  settings.tile_w)
            nt_prod = (min(settings.live_tile_cap, nt_full) if can_compact
                       else nt_full)
            q_cap, e_cap = settings.sample_route_caps
            esc_n = flags.sum(dtype=torch.int32)
            over_q = torch.clamp(nt_prod - esc_n - min(int(q_cap), nt_prod),
                                 min=0)
            diags.append(_tile_diag(torch.clamp(
                esc_n + over_q - min(int(e_cap), nt_prod), min=0), dev))
        if can_compact:
            live = (px.tri_id >= 0).any(dim=1)
            if settings.outputs == "full":
                # Debug frames shade at full rate but still report whether
                # the production cap would overflow.
                over = torch.clamp(live.sum(dtype=torch.int32)
                                   - settings.live_tile_cap, min=0)
                diags.append(_tile_diag(over, dev))
            else:
                compact_ids, dropped = _compact_ids(
                    live, settings.live_tile_cap, nt_full)
                diags.append(_tile_diag(dropped, dev))

                px = _slot_pixels(px, compact_ids)

        light_vis = None
        if (settings.enable_shadows and scene.lights.num_lights > 0
                and not flat):
            smap, sh_diag = _shadow_map_any(soup, scene, settings, kernels)
            vis_plane, sh_diag = _pcf_vis(smap, px, settings, sh_diag)
            light_vis = {settings.shadow_light: vis_plane}
            diags.append(sh_diag)

        ldr3, hdr3, gb = _shade(px, materials, scene.lights, view_block,
                                frame_params, settings, kernels, light_vis,
                                ibl, diags)

    with stage_scope("frame.overlay"):
        spheres = (settings.show_lights and overlay is not None
                   and scene.lights.num_lights > 0)
        show_hud = settings.show_hud and hud is not None
        ldr = ldr3
        if compact_ids is not None or spheres or show_hud:
            ldr = _ldr_planes(ldr3, compact_ids, nt_full)
        del ldr3  # a compacted shade output is not needed past the scatter
        view_proj = m3.matmul(view_block.proj, view_block.view)
        if spheres:
            ldr, sp_diag = _composite_light_spheres(
                ldr, zkey, scene.lights, overlay, view_proj, settings,
                kernels)
            diags.append(sp_diag)
        if show_hud:
            ldr, hud_diag = _composite_hud(ldr, hud, settings, kernels)
            diags.append(hud_diag)

        ldr3_img = tuple(_untile(c, settings) for c in ldr)
        if settings.show_tbn and overlay is not None:
            if isinstance(soup, PlanarSoup):  # lines read (T, 3) face data
                soup = assemble_scene(scene.batches, view_block.view,
                                      view_block.proj,
                                      settings.batch_material_ids)
            ldr3_img = _composite_tbn(ldr3_img, soup,
                                      _untile(px.depth, settings), view_proj,
                                      settings)
        if settings.show_gizmo and overlay is not None:
            ldr3_img, gz_diag = _composite_gizmo(
                ldr3_img, view_block.view, view_block.proj, overlay, settings,
                kernels)
            diags.append(gz_diag)

    with stage_scope("frame.output"):
        if settings.srgb_output:
            out3 = tuple(srgb_encode(c) for c in ldr3_img)
        else:
            out3 = tuple(torch.clamp(c, 0.0, 1.0) for c in ldr3_img)
        image = to_u8(torch.stack(out3, dim=-1))

        if settings.outputs == "image":
            out = {"image": image}
        elif settings.outputs == "image+diag":
            out = {"image": image, "bin_diag": fused.sum_diags(diags)}
        else:
            out = {
                "image": image,
                "ldr": torch.stack(ldr3_img, dim=-1),
                "hdr": torch.stack([_untile(c, settings) for c in hdr3], -1),
                "depth": _untile(px.depth, settings),
                "tri_id": _untile(px.tri_id, settings),
                "gbuffer": gb,
                "bin_diag": fused.sum_diags(diags),
            }
        if validation_active():
            check_frame_output({"ldr": torch.stack(ldr3_img, dim=-1), **out})
    return out


# Size groups above this many texels bind as block tables.
BLOCK_TABLE_THRESHOLD = 1 << 20


def material_quads_from_set(material_set, index: int,
                            block_threshold: int | None
                            = BLOCK_TABLE_THRESHOLD, device="cuda") -> tuple:
    """Bind one material as grouped quad/block tables."""
    return tq.build_quad_tables(tq.pack_material_maps(material_set, index),
                                block_threshold=block_threshold,
                                device=device)


def material_textures_from_set(material_set, index: int,
                               device="cuda") -> MaterialTextures:
    """One material's level-0 maps as the image-space binding."""
    from bibim_tpu_torch.assets.materials import PBRMapType

    def level0(t):
        return torch.as_tensor(np.ascontiguousarray(
            material_set.get_pbr_map_or_default(index, t)[0]), device=device)

    return MaterialTextures(
        albedo=level0(PBRMapType.ALBEDO),
        metallic=level0(PBRMapType.METALLIC),
        roughness=level0(PBRMapType.ROUGHNESS), ao=level0(PBRMapType.AO),
        normal=level0(PBRMapType.NORMAL), height=level0(PBRMapType.HEIGHT))


def material_mip_quads_from_set(material_set, index: int,
                                device="cuda") -> tuple:
    """One material's mip chains as mip-quad tables (the single-material
    trilinear binding)."""
    from bibim_tpu_torch.assets.materials import PBRMapType

    def mips(t):
        return [np.asarray(m)
                for m in material_set.get_pbr_map_or_default(index, t)]

    alb = mips(PBRMapType.ALBEDO)
    nrm = mips(PBRMapType.NORMAL)
    return tq.build_mip_quad_tables({
        "alb_r": [m[:, :, 0:1] for m in alb],
        "alb_g": [m[:, :, 1:2] for m in alb],
        "alb_b": [m[:, :, 2:3] for m in alb],
        "nrm_x": [m[:, :, 0:1] for m in nrm],
        "nrm_y": [m[:, :, 1:2] for m in nrm],
        "nrm_z": [m[:, :, 2:3] for m in nrm],
        "metallic": mips(PBRMapType.METALLIC),
        "roughness": mips(PBRMapType.ROUGHNESS),
        "ao": mips(PBRMapType.AO), "height": mips(PBRMapType.HEIGHT),
    }, device=device)


def material_mips_from_set(material_set, index: int,
                           device="cuda") -> MaterialMips:
    """One material's mip chains as the image-space trilinear binding."""
    from bibim_tpu_torch.assets.materials import PBRMapType

    def atlas(t):
        return tx.build_mip_atlas(
            material_set.get_pbr_map_or_default(index, t), device=device)

    return MaterialMips(
        albedo=atlas(PBRMapType.ALBEDO), metallic=atlas(PBRMapType.METALLIC),
        roughness=atlas(PBRMapType.ROUGHNESS), ao=atlas(PBRMapType.AO),
        normal=atlas(PBRMapType.NORMAL), height=atlas(PBRMapType.HEIGHT))


def make_overlay_resources(device="cuda", with_gizmo: bool = True
                           ) -> OverlayResources:
    """Light-sphere mesh (r=0.1, 16×16) and, with ``with_gizmo``, the gizmo
    mesh from the resource root's gizmo.obj."""
    sphere = generate_uv_sphere_mesh(0.1, 16, 16)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    res = OverlayResources(sphere_positions=t(sphere.positions),
                           sphere_tris=t(sphere.indices, torch.int32))
    if not with_gizmo:
        return res
    from bibim_tpu_torch.assets.obj import load_obj
    from bibim_tpu_torch.utils.config import get_resource_root

    gizmo = load_obj(get_resource_root().common("gizmo.obj"))
    colors = (gizmo.colors if gizmo.colors is not None
              else np.ones_like(gizmo.positions))
    return res._replace(
        gizmo_positions=t(gizmo.positions), gizmo_normals=t(gizmo.normals),
        gizmo_colors=t(colors), gizmo_tris=t(gizmo.indices, torch.int32))
