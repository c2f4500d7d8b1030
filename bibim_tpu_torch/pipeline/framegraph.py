"""The frame function (port of ``bibim_tpu.pipeline.framegraph``, the
deferred PBR branch).

Stages of :func:`render_frame`:

1. vertex transforms on corner planes (``ops.geometry``), triangle setup
   and record table;
2. binning (pair sort K3) and raster + resolve (K1) of the main pass;
3. optional live-tile compaction of the shading stage (``live_tile_cap``);
4. sampled shade (K2): materials, normal map, fp16 G-buffer, GGX; then the
   fp16 HDR round trip and the exposure tone map as torch ops;
5. scatter-back, light spheres through the overlay composite (K4, depth
   tested against the scene's keys), the corner gizmo (K1 in its own
   viewport), sRGB encode and u8.

Settings outside this slice (forward lighting, shadows, IBL, pair sampling,
anisotropic taps, early-z and the other raster schedule variants, HUD, TBN,
G-buffer visualization, flat main-frame shading) raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, NamedTuple

import numpy as np
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops import sort as sort_ops
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.geometry import PlanarSoup, assemble_scene_planar
from bibim_tpu_torch.ops.raster import triangle_setup, triangle_setup_planar
from bibim_tpu_torch.ops.shading import q16, shade_sampled, shade_sampled_plain
from bibim_tpu_torch.ops.shading_planar import (
    apply_normal_map,
    shade_flat_planar,
    shade_pbr_planar,
)
from bibim_tpu_torch.ops.tonemap import srgb_encode, to_u8, tone_map
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
    """The four kernel entry points the frame calls."""

    raster: Callable
    overlay: Callable
    sort: Callable
    shade: Callable


# The kernel wrappers (CUDA kernels for CUDA tensors) ...
KERNELS = Kernels(fused.raster_tiles, fused.overlay_tiles,
                  sort_ops.sort_keys, shade_sampled)
# ... and their plain PyTorch versions on any device (reference renders).
PLAIN = Kernels(fused.raster_tiles_plain, fused.overlay_tiles_plain,
                sort_ops.sort_keys_plain, shade_sampled_plain)


def check_supported(settings: RenderSettings, materials) -> None:
    """Raise NotImplementedError for any setting outside this slice."""
    s = settings
    checks = [
        (not s.deferred, "deferred=False (forward lighting)"),
        (s.shading != "pbr", f"shading={s.shading!r}"),
        (s.gbuffer_viz != GBufferViz.RENDERED_SCENE,
         f"gbuffer_viz={s.gbuffer_viz!r}"),
        (s.show_tbn, "show_tbn"),
        (s.show_hud, "show_hud"),
        (s.enable_shadows, "enable_shadows"),
        (s.enable_ibl, "enable_ibl"),
        (s.aniso_taps != 1, f"aniso_taps={s.aniso_taps}"),
        (bool(s.pair_sampling), f"pair_sampling={s.pair_sampling}"),
        (s.pair_lossy, "pair_lossy"),
        (s.pair_visibility, "pair_visibility"),
        (s.early_z, "early_z"),
        (s.fine_bins, "fine_bins"),
        (s.group_pair_cap is not None, "group_pair_cap"),
        (s.merged_coverage, "merged_coverage"),
        (s.raster != "auto", f"raster={s.raster!r}"),
        (s.geometry == "legacy", "geometry='legacy'"),
        (not s.sequential_tris, "sequential_tris=False"),
        (s.batch_material_ids is not None, "batch_material_ids"),
        (s.outputs not in ("image", "image+diag", "full"),
         f"outputs={s.outputs!r}"),
    ]
    bad = [msg for cond, msg in checks if cond]
    if not (isinstance(materials, tuple) and materials and all(
            isinstance(t, (tq.QuadTable, tq.BlockTable)) for t in materials)):
        bad.append("materials other than a tuple of QuadTable/BlockTable")
    if bad:
        raise NotImplementedError(
            "not in the ported frame slice: " + ", ".join(bad))


def _prunable_fields(settings: RenderSettings) -> tuple:
    """Raster output planes the production frame never reads."""
    if settings.outputs == "full":
        return ()
    return ("depth", "b0", "b1", "cr", "cg", "cb", "matf")


def _raster(rec, setup, width, height, settings: RenderSettings,
            kernels: Kernels, cap=None, init_zkey=None, overflow_cap=None,
            passes=None, main_pass=False, span_cap=None, drop_fields=None):
    if passes is None:
        passes = settings.raster_passes if cap is None else 1
    return fused.raster_fused(
        rec, setup, width, height, tile_h=settings.tile_h,
        tile_w=settings.tile_w,
        max_candidates=cap or settings.max_candidates,
        overflow_cap=overflow_cap or settings.overflow_cap,
        span_cap=span_cap or settings.span_cap, init_zkey=init_zkey,
        pair_budget=settings.pair_budget, passes=passes,
        raster_tile_cap=settings.raster_tile_cap if main_pass else None,
        span_mid_cap=settings.span_mid_cap if main_pass else None,
        dense_tile_cap=settings.dense_tile_cap if main_pass else None,
        drop_fields=(drop_fields if drop_fields is not None
                     else (_prunable_fields(settings) if main_pass else ())),
        raster=kernels.raster, sort=kernels.sort,
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
                                settings: RenderSettings):
    """Plain G-buffer: material samples + normal map + mask + fp16."""
    valid = px.tri_id >= 0
    slots = tq.sample_material(materials, px.uv[0], px.uv[1])
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


def render_frame(scene: SceneData, view_block: ViewBlock,
                 frame_params: FrameParams, materials,
                 overlay: OverlayResources | None, settings: RenderSettings,
                 kernels: Kernels = KERNELS):
    """Render one deferred PBR frame.

    ``settings.outputs``: "image" → {'image': (H,W,3) u8}; "image+diag"
    adds the summed BinDiag of every raster pass; "full" shades through
    the plain G-buffer chain and adds ldr/hdr/depth/tri_id/gbuffer images.
    ``kernels`` selects the kernel entry points (default: the wrappers;
    :data:`PLAIN` renders a reference frame with the plain versions on any
    device)."""
    check_supported(settings, materials)
    if settings.show_gizmo and overlay is not None \
            and overlay.gizmo_tris is None:
        raise ValueError("show_gizmo needs OverlayResources with a gizmo "
                         "mesh")
    width, height = settings.width, settings.height
    dev = view_block.view.device

    psoup = assemble_scene_planar(scene.batches, view_block.view,
                                  view_block.proj, settings.batch_material_ids)
    setup = triangle_setup_planar(psoup.clip, width, height)
    rec = fused.build_record_table_planar(setup, psoup)
    px, zkey, diag = _raster(rec, setup, width, height, settings, kernels,
                             main_pass=True)
    diags = [diag]

    nt_full = px.tri_id.shape[0]
    compact_ids = None
    can_compact = (settings.live_tile_cap is not None
                   and settings.live_tile_cap < nt_full)
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
    if settings.outputs != "full":
        hdr3 = kernels.shade(
            materials, px.uv[0], px.uv[1], px.world, px.normal, px.tangent,
            valid, scene.lights, view_block.view_pos,
            view_block.enable_normal_map, gbuffer_mode=True,
            quantize=settings.quantize_fp16)
    else:
        g_pos, g_nrm, g_alb, g_mrah, valid = _materialize_gbuffer_planes(
            px, materials, view_block, settings)
        hdr3 = shade_pbr_planar(g_pos, g_nrm, g_alb, g_mrah[0], g_mrah[1],
                                g_mrah[2], scene.lights, view_block.view_pos)
        zero = torch.zeros_like(px.depth)
        hdr3 = tuple(torch.where(valid, c, zero) for c in hdr3)

        def img3(planes):
            return torch.stack([_untile(c, settings) for c in planes], -1)

        gb = {
            "position": img3(g_pos), "normal": img3(g_nrm),
            "albedo": img3(g_alb), "mrah": img3(g_mrah),
            "matindex": img3((torch.where(valid, 1.0, 0.0), zero, zero)),
        }
    if settings.quantize_fp16:
        hdr3 = tuple(q16(c) for c in hdr3)
    ldr3 = tuple(tone_map(c, frame_params.enable_tone_mapping,
                          frame_params.exposure) for c in hdr3)

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
                            = BLOCK_TABLE_THRESHOLD, device="cpu") -> tuple:
    """Bind one material as grouped quad/block tables."""
    return tq.build_quad_tables(tq.pack_material_maps(material_set, index),
                                block_threshold=block_threshold,
                                device=device)


def make_overlay_resources(device="cpu", with_gizmo: bool = True
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
    from bibim_tpu.assets.obj import load_obj
    from bibim_tpu.utils.config import get_resource_root

    gizmo = load_obj(get_resource_root().common("gizmo.obj"))
    colors = (gizmo.colors if gizmo.colors is not None
              else np.ones_like(gizmo.positions))
    return res._replace(
        gizmo_positions=t(gizmo.positions), gizmo_normals=t(gizmo.normals),
        gizmo_colors=t(colors), gizmo_tris=t(gizmo.indices, torch.int32))
