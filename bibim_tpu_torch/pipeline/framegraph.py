"""The frame function (port of ``bibim_tpu.pipeline.framegraph``, the
deferred PBR branch with shadows, IBL, trilinear mip bindings with
per-batch material routing, and the G-buffer views).

Stages of :func:`render_frame`:

1. vertex transforms on corner planes (``ops.geometry``), triangle setup
   and record table;
2. binning (pair sort K3) and raster + resolve (K1) of the main pass;
3. optional live-tile compaction of the shading stage (``live_tile_cap``);
4. with ``enable_shadows``: the light-view depth pass (K3 + K1 on the
   shadow map's grid, depth plane only) and the screen-side PCF
   visibility of the shadow-casting light (``ops.shadow``);
5. shading, either
   - without IBL: the sampled shade (K2) — materials (block, quad,
     mip-block and material-routed small groups), normal map, fp16
     G-buffer, GGX with the visibility plane; or
   - with IBL, a G-buffer view, or a binding K2 cannot sample: the
     G-buffer planes sampled through the block-table (K6), small-table
     (K7) and mip-block (K8) samplers, then the split-sum IBL ambient
     (``ops.ibl``) and the G-buffer shade (K5), or for a G-buffer view
     the raw planes as HDR;
   then the fp16 HDR round trip and the exposure tone map as torch ops;
6. scatter-back, light spheres through the overlay composite (K4, depth
   tested against the scene's keys), the corner gizmo (K1 in its own
   viewport), sRGB encode and u8.

The main pass takes the reference's raster schedule variants: early-z
(K9, every pass), the group window (K10) and fine subtiles (K11);
``merged_coverage`` is accepted and has no counterpart. Settings outside the port (forward lighting,
pair sampling and pair visibility, anisotropic taps, HUD, TBN, flat
main-frame shading) raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, NamedTuple

import numpy as np
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops import shadow as sh
from bibim_tpu_torch.ops import sort as sort_ops
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.geometry import PlanarSoup, assemble_scene_planar
from bibim_tpu_torch.ops.ibl import ibl_ambient
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
    sample_block: Callable  # K6: (BlockTable, u, v) → slot planes
    # K7: (quads, idx, tx, ty, present) → slot planes
    sample_small: Callable
    # K8: (MipBlockMulti, mat_id, u, v, tile_h, tile_w) → slot planes
    sample_mip_block: Callable
    raster_earlyz: Callable  # K9
    raster_gw: Callable  # K10
    raster_fine: Callable  # K11


# The kernel wrappers (CUDA kernels for CUDA tensors) ...
KERNELS = Kernels(fused.raster_tiles, fused.overlay_tiles,
                  sort_ops.sort_keys, shade_sampled, shade_tonemap,
                  tq.sample_table_block_kernel, tq.sample_rows_small,
                  tq.sample_mip_block_kernel, fused.raster_tiles_earlyz,
                  fused.raster_tiles_gw, fused.raster_tiles_fine)
# ... and their plain PyTorch versions on any device (reference renders).
PLAIN = Kernels(fused.raster_tiles_plain, fused.overlay_tiles_plain,
                sort_ops.sort_keys_plain, shade_sampled_plain,
                shade_tonemap_plain, tq.sample_table_block,
                tq.sample_rows_small_plain, tq.sample_mip_block,
                fused.raster_tiles_earlyz_plain, fused.raster_tiles_gw_plain,
                fused.raster_tiles_fine_plain)

_TABLES = (tq.QuadTable, tq.BlockTable)
_MIP_TABLES = (tq.MipBlockMulti, tq.MipQuadMulti)


def _is_mip_binding(materials) -> bool:
    return isinstance(materials[0], _MIP_TABLES)


def check_supported(settings: RenderSettings, materials) -> None:
    """Raise NotImplementedError for any setting outside this slice."""
    s = settings
    checks = [
        (not s.deferred, "deferred=False (forward lighting)"),
        (s.shading != "pbr", f"shading={s.shading!r}"),
        (s.show_tbn, "show_tbn"),
        (s.show_hud, "show_hud"),
        (s.aniso_taps != 1, f"aniso_taps={s.aniso_taps}"),
        (bool(s.pair_sampling), f"pair_sampling={s.pair_sampling}"),
        (s.pair_lossy, "pair_lossy"),
        (s.pair_visibility, "pair_visibility"),
        (s.raster != "auto", f"raster={s.raster!r}"),
        (s.geometry == "legacy", "geometry='legacy'"),
        (not s.sequential_tris, "sequential_tris=False"),
        (s.outputs not in ("image", "image+diag", "full"),
         f"outputs={s.outputs!r}"),
    ]
    bad = [msg for cond, msg in checks if cond]
    if not (isinstance(materials, tuple) and materials and (
            all(isinstance(t, _TABLES) for t in materials)
            or all(isinstance(t, _MIP_TABLES) for t in materials))):
        bad.append("materials other than a tuple of QuadTable/BlockTable "
                   "or of MipBlockMulti/MipQuadMulti")
    if bad:
        raise NotImplementedError(
            "not in the ported frame slice: " + ", ".join(bad))


def _prunable_fields(settings: RenderSettings) -> tuple:
    """Raster output planes the production frame never reads: none for
    "full" or a G-buffer view; the material-id plane only without
    per-batch material ids."""
    if (settings.outputs == "full"
            or settings.gbuffer_viz != GBufferViz.RENDERED_SCENE):
        return ()
    drop = ("depth", "b0", "b1", "cr", "cg", "cb")
    return drop if settings.batch_material_ids is not None \
        else drop + ("matf",)


def _raster(rec, setup, width, height, settings: RenderSettings,
            kernels: Kernels, cap=None, init_zkey=None, overflow_cap=None,
            passes=None, main_pass=False, span_cap=None, drop_fields=None,
            tile_cap=None):
    """``tile_cap``: the pass-0 tile compaction of a pass that is not the
    main one (the main pass takes ``settings.raster_tile_cap``). Early-z
    applies to every pass (shadow and gizmo too), the group window and
    fine bins to the main pass only."""
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
        earlyz=settings.early_z,
        raster=kernels.raster, raster_earlyz=kernels.raster_earlyz,
        raster_gw=kernels.raster_gw, raster_fine=kernels.raster_fine,
        sort=kernels.sort,
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


def _map_pixels(px: fused.FusedPixels, fn) -> fused.FusedPixels:
    def go(x):
        if isinstance(x, tuple):
            return tuple(go(c) for c in x)
        return fn(x)

    return fused.FusedPixels(*(go(x) for x in px))


def _tile_diag(dropped, device) -> fused.BinDiag:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return fused.BinDiag(z, z, z, dropped.to(torch.int32))


def _materialize_gbuffer_planes(px, materials, view_block,
                                settings: RenderSettings,
                                kernels: Kernels | None = None):
    """G-buffer planes: material samples (through ``kernels``' K6/K7/K8,
    or the plain XLA-order samplers with None; mip bindings routed per
    pixel by the material-id plane) + normal map + mask + fp16."""
    valid = px.tri_id >= 0
    u, v = px.uv
    if _is_mip_binding(materials):
        slots = tq.sample_material_mips_multi(
            materials, px.mat_id, u, v, settings.tile_h, settings.tile_w,
            kernels)
    else:
        slots = tq.sample_material(materials, u, v, kernels)
    albedo = (slots["alb_r"], slots["alb_g"], slots["alb_b"])
    nmap = (slots["nrm_x"], slots["nrm_y"], slots["nrm_z"])
    normal = apply_normal_map(px.normal, px.tangent, nmap,
                              view_block.enable_normal_map)
    zero = torch.zeros_like(px.depth)

    def mq(ch):
        ch = torch.where(valid, ch, zero)
        return q16(ch) if settings.quantize_fp16 else ch

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


def _shadow_fit_ranges(scene: SceneData, settings: RenderSettings):
    """(start, end) slices of the concatenated triangle planes of the
    ``settings.shadow_fit_batches`` batches (None: the fit covers the
    whole scene)."""
    if settings.shadow_fit_batches is None:
        return None
    out = []
    t0 = 0
    for bi, b in enumerate(scene.batches):
        t1 = t0 + int(b.model.shape[0]) * int(b.indices.shape[0])
        if bi in settings.shadow_fit_batches:
            out.append((t0, t1))
        t0 = t1
    return tuple(out)


def _world_bounds_planar(world, ranges=None):
    """(min, max) (3,) bounds of corner-planar world planes, optionally
    over (start, end) triangle slices."""
    sl = ranges if ranges else ((0, None),)

    def bound(k, fn):
        return fn(torch.stack([fn(world[k][c][s:e]) for c in range(3)
                               for (s, e) in sl]))

    return (torch.stack([bound(k, torch.min) for k in range(3)]),
            torch.stack([bound(k, torch.max) for k in range(3)]))


def _shadow_map_planar(psoup: PlanarSoup, lights: Lights,
                       settings: RenderSettings, kernels: Kernels,
                       fit_ranges=None):
    """Depth-only light pass through the frame's raster (K1, every plane
    but depth dropped) → (ShadowMap, BinDiag of the pass)."""
    size = settings.shadow_size
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
    add to the shadow pass's BinDiag)."""
    if settings.shadow_query_tile_cap is not None:
        vis, dropped = sh.shadow_factor_compact(
            smap, px.world, px.tri_id >= 0, settings.shadow_query_tile_cap,
            settings.shadow_bias)
        return vis, sh_diag._replace(
            dropped_tiles=sh_diag.dropped_tiles + dropped)
    return sh.shadow_factor(smap, px.world, settings.shadow_bias), sh_diag


def _shadow_visibility_planar(psoup, px, lights, settings: RenderSettings,
                              kernels: Kernels, fit_ranges=None):
    smap, sh_diag = _shadow_map_planar(psoup, lights, settings, kernels,
                                       fit_ranges=fit_ranges)
    return _pcf_vis(smap, px, settings, sh_diag)


def _shadow_vis_any(psoup, px, scene: SceneData, settings: RenderSettings,
                    kernels: Kernels):
    """Visibility plane of the shadow-casting light and the shadow pass's
    BinDiag (the port's frame is planar only)."""
    return _shadow_visibility_planar(psoup, px, scene.lights, settings,
                                     kernels,
                                     _shadow_fit_ranges(scene, settings))


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


def _composite_light_spheres(ldr3, zkey, lights: Lights,
                             overlay: OverlayResources, view_proj,
                             settings: RenderSettings, kernels: Kernels):
    soup = _light_sphere_planar_soup(lights, overlay, view_proj)
    setup = triangle_setup_planar(soup.clip, settings.width, settings.height)
    rec = fused.build_record_table_planar(setup, soup)
    return fused.composite_overlay(
        rec, setup, ldr3, zkey, settings.width, settings.height,
        tile_h=settings.tile_h, tile_w=settings.tile_w,
        max_candidates=settings.overlay_candidates,
        overflow_cap=settings.overlay_overflow_cap, span_cap=32,
        max_tiles=min(settings.overlay_max_tiles,
                      settings.tiles_x * settings.tiles_y),
        span_mid_cap=max(256, rec.shape[0] // 4),
        overlay=kernels.overlay, sort=kernels.sort,
    )


def _gizmo_clip(view, proj, overlay: OverlayResources):
    """Gizmo vertices → clip through the gizmo viewport camera (main-view
    rotation, camera 27 back along the look vector, 30° fov)."""
    rot = view[:3, :3]
    look = view[2, :3]
    view_pos = look * -27.0
    trans = -(rot @ view_pos)
    gz_view = view.clone()
    gz_view[:3, 3] = trans
    d = 1.0 / torch.tan(torch.tensor(0.261799, dtype=torch.float32,
                                     device=view.device))
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


def _composite_gizmo(ldr3_img, view, proj, overlay: OverlayResources,
                     settings: RenderSettings, kernels: Kernels):
    ext = settings.gizmo_extent
    hit, rgb, gz_diag = _render_gizmo(view, proj, overlay, settings, kernels)
    ey = min(ext, settings.height)
    ex = min(ext, settings.width)
    x0 = settings.width - ex
    out = []
    for c in range(3):
        img = ldr3_img[c].clone()
        img[0:ey, x0:] = torch.where(hit[:ey, :ex], rgb[c][:ey, :ex],
                                     img[0:ey, x0:])
        out.append(img)
    return tuple(out), gz_diag


def _assemble_and_raster(scene: SceneData, view_block: ViewBlock,
                         settings: RenderSettings, kernels: Kernels):
    """The main pass: corner-planar vertex stage, setup, records, raster.
    Returns (pixels, zkey, diag, planar soup)."""
    psoup = assemble_scene_planar(scene.batches, view_block.view,
                                  view_block.proj, settings.batch_material_ids)
    setup = triangle_setup_planar(psoup.clip, settings.width, settings.height)
    rec = fused.build_record_table_planar(setup, psoup)
    px, zkey, diag = _raster(rec, setup, settings.width, settings.height,
                             settings, kernels, main_pass=True)
    return px, zkey, diag, psoup


def render_frame(scene: SceneData, view_block: ViewBlock,
                 frame_params: FrameParams, materials,
                 overlay: OverlayResources | None, settings: RenderSettings,
                 ibl=None, kernels: Kernels = KERNELS):
    """Render one deferred PBR frame.

    ``settings.outputs``: "image" → {'image': (H,W,3) u8}; "image+diag"
    adds the summed BinDiag of every raster pass; "full" shades through
    the plain G-buffer chain (XLA-order samplers, planar GGX) and adds
    ldr/hdr/depth/tri_id/gbuffer images. ``ibl`` (``ops.ibl.IblSH`` or
    ``IblMaps``) is the light probe ``settings.enable_ibl`` shades with.
    ``kernels`` selects the kernel entry points (default: the wrappers;
    :data:`PLAIN` renders a reference frame with the plain versions on any
    device)."""
    check_supported(settings, materials)
    if settings.show_gizmo and overlay is not None \
            and overlay.gizmo_tris is None:
        raise ValueError("show_gizmo needs OverlayResources with a gizmo "
                         "mesh")
    dev = view_block.view.device

    px, zkey, diag, psoup = _assemble_and_raster(scene, view_block,
                                                 settings, kernels)
    diags = [diag]

    nt_full = px.tri_id.shape[0]
    compact_ids = None
    viz = settings.gbuffer_viz != GBufferViz.RENDERED_SCENE
    can_compact = (settings.live_tile_cap is not None
                   and settings.live_tile_cap < nt_full and not viz)
    if can_compact:
        live = (px.tri_id >= 0).any(dim=1)
        if settings.outputs == "full":
            # Debug frames shade at full rate but still report whether the
            # production cap would overflow.
            over = torch.clamp(live.sum(dtype=torch.int32)
                               - settings.live_tile_cap, min=0)
            diags.append(_tile_diag(over, dev))
        else:
            compact_ids, dropped = _compact_ids(live, settings.live_tile_cap,
                                                nt_full)
            diags.append(_tile_diag(dropped, dev))

            def sub(p):
                fill = -1 if p is px.tri_id else 0
                pad = torch.full_like(p[:1], fill)
                return torch.cat([p, pad])[compact_ids].contiguous()

            px = _map_pixels(px, sub)

    valid = px.tri_id >= 0
    gb = {}
    light_vis = None
    if settings.enable_shadows and scene.lights.num_lights > 0:
        vis_plane, sh_diag = _shadow_vis_any(psoup, px, scene, settings,
                                             kernels)
        light_vis = {settings.shadow_light: vis_plane}
        diags.append(sh_diag)

    ldr3 = None
    production = settings.outputs != "full"
    if (production and not settings.enable_ibl and not viz
            and sampled_groups_supported(materials)):
        # K2 with the frame's fp16 + tone-map tail as its epilogue.
        ldr3 = kernels.shade(
            materials, px.uv[0], px.uv[1], px.world, px.normal, px.tangent,
            valid, scene.lights, view_block.view_pos,
            view_block.enable_normal_map, quantize=settings.quantize_fp16,
            vis_plane=_vis_plane(light_vis, settings),
            vis_light=settings.shadow_light, mat_id=px.mat_id,
            tile_h=settings.tile_h, tile_w=settings.tile_w,
            quantize_hdr=settings.quantize_fp16, tonemap=True,
            enable_tone_mapping=frame_params.enable_tone_mapping,
            exposure=frame_params.exposure)
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
                                  scene.lights, view_block, frame_params,
                                  settings, kernels, light_vis, ambient)
        else:
            hdr3 = _pbr_hdr(g_pos, g_nrm, g_alb, g_mrah, valid,
                            scene.lights, view_block, light_vis, ambient)
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

    if compact_ids is not None:
        npx = ldr3[0].shape[1]

        def scatter(c):
            full = torch.zeros((nt_full + 1, npx), dtype=c.dtype, device=dev)
            full[compact_ids] = c
            return full[:nt_full]

        ldr3 = tuple(scatter(c) for c in ldr3)

    view_proj = m3.matmul(view_block.proj, view_block.view)
    if settings.show_lights and overlay is not None \
            and scene.lights.num_lights > 0:
        ldr3, sp_diag = _composite_light_spheres(
            ldr3, zkey, scene.lights, overlay, view_proj, settings, kernels)
        diags.append(sp_diag)

    ldr3_img = tuple(_untile(c, settings) for c in ldr3)
    if settings.show_gizmo and overlay is not None:
        ldr3_img, gz_diag = _composite_gizmo(
            ldr3_img, view_block.view, view_block.proj, overlay, settings,
            kernels)
        diags.append(gz_diag)

    if settings.srgb_output:
        out3 = tuple(srgb_encode(c) for c in ldr3_img)
    else:
        out3 = tuple(torch.clamp(c, 0.0, 1.0) for c in ldr3_img)
    image = to_u8(torch.stack(out3, dim=-1))

    if settings.outputs == "image":
        return {"image": image}
    total_diag = fused.sum_diags(diags)
    if settings.outputs == "image+diag":
        return {"image": image, "bin_diag": total_diag}
    return {
        "image": image,
        "ldr": torch.stack(ldr3_img, dim=-1),
        "hdr": torch.stack([_untile(c, settings) for c in hdr3], -1),
        "depth": _untile(px.depth, settings),
        "tri_id": _untile(px.tri_id, settings),
        "gbuffer": gb,
        "bin_diag": total_diag,
    }


# Size groups above this many texels bind as block tables.
BLOCK_TABLE_THRESHOLD = 1 << 20


def material_quads_from_set(material_set, index: int,
                            block_threshold: int | None
                            = BLOCK_TABLE_THRESHOLD, device="cuda") -> tuple:
    """Bind one material as grouped quad/block tables."""
    return tq.build_quad_tables(tq.pack_material_maps(material_set, index),
                                block_threshold=block_threshold,
                                device=device)


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
