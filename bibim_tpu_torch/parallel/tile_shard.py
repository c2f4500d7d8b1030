"""The band-sharded frame (port of ``bibim_tpu.parallel.tile_shard``):
sort-middle rendering over a ``parallel.mesh.DeviceMesh``.

Each band: the replicated scene → vertex stage → binning and raster of
its horizontal band of the frame only → live-tile compaction, sampling
and shading of its tiles → the light spheres that reach it → its rows of
the corner gizmo. Bands are independent, so the only data that crosses
devices is the band rows of the image and the four drop counts of each
band's BinDiag.

A band runs the unmodified kernels. Its triangle setup puts the bounding
boxes in band rows (``ops.raster``, ``band_y0``), so binning covers the
band's tiles only; its records stay in frame coordinates, and the raster
kernels, which read a slot's tile id only for its pixel centres, get the
slots' frame tile ids (``ops.fused.raster_fused``, ``band_y0``): every
pixel of the main pass rounds as in the single-card frame. The light
spheres composite into the band's own planes, which the overlay kernel
indexes by band tile, so their records are rebased to band rows instead
(``ops.fused.shift_record_table_y``: C += B·y0, rounded apart from the
frame's B·py + C, so a sphere's silhouette may differ by an ulp). A frame
height that does not divide into whole-tile bands is padded to whole
bands and cropped after the gather.

Once per device (not per band): the shadow map, built from the full
scene; the corner gizmo, rendered in its own viewport (each band
composites its rows of it).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops.tonemap import srgb_encode, to_u8
from bibim_tpu_torch.pipeline.autotune import (
    autotune_settings_sharded,
    band_height,
    grow_caps,
)
from bibim_tpu_torch.pipeline.framegraph import (
    KERNELS,
    FrameParams,
    GBufferViz,
    Kernels,
    OverlayResources,
    RenderSettings,
    ViewBlock,
    _assemble,
    _assemble_and_raster,
    _compact_ids,
    _composite_light_spheres,
    _gizmo_into,
    _ldr_planes,
    _pcf_vis,
    _planar_materials,
    _render_gizmo,
    _shade,
    _shadow_map_any,
    _slot_pixels,
    _tile_diag,
    _untile,
    check_supported,
)
from bibim_tpu_torch.scene.scene import SceneData
from bibim_tpu_torch.utils.log import log_info
from bibim_tpu_torch.utils.profiling import stage_scope
from bibim_tpu_torch.utils.validation import (
    check_bin_diag,
    check_frame_output,
    validation_active,
)


def _band_cap(cap: int | None, n: int, band_nt: int) -> int | None:
    """A frame-level compact-grid capacity scaled to one of ``n`` bands,
    with slack (coverage is rarely even across bands); the summed BinDiag
    still validates it."""
    if cap is None:
        return None
    return min(-(-cap // n) + 8 + band_nt // 8, band_nt)


def _band_view(settings: RenderSettings, band_h: int) -> RenderSettings:
    """Settings with the band's height (for helpers that derive
    tiles_y)."""
    return dataclasses.replace(settings, height=band_h)


def _diag_has_drops(diag) -> bool:
    return any(int(v) > 0 for v in diag)


def _to(x, device):
    """Every tensor of ``x`` (nested tuples, NamedTuples, lists, dicts) on
    ``device``; a tensor already there is the same tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _band_rows(k: int, band_h: int, scene: SceneData, view_block: ViewBlock,
               frame_params: FrameParams, materials,
               settings: RenderSettings, band_settings: RenderSettings,
               band_live_cap, overlay, ibl, smap, gizmo, kernels: Kernels):
    """Band ``k``: its (band_h, W, 3) u8 rows and its drop counts, an
    (4,) int32 tensor in BinDiag order."""
    y0 = k * band_h
    band = (band_h, y0)
    px, zkey, diag, _ = _assemble_and_raster(scene, view_block, band_settings,
                                             kernels, band=band)
    diags = [diag]
    dev = px.tri_id.device
    # The band's production frame at band height (shading, untile).
    view = dataclasses.replace(_band_view(band_settings, band_h),
                               outputs="image")
    nt = px.tri_id.shape[0]
    compact_ids = None
    if (band_live_cap is not None and band_live_cap < nt
            and _planar_materials(materials)):
        live = (px.tri_id >= 0).any(dim=1)
        compact_ids, dropped = _compact_ids(live, band_live_cap, nt)
        diags.append(_tile_diag(dropped, dev))
        px = _slot_pixels(px, compact_ids)
    light_vis = None
    if smap is not None:
        no_drops = _tile_diag(torch.zeros((), dtype=torch.int32,
                                          device=dev), dev)
        vis, q_diag = _pcf_vis(smap, px, view, no_drops)
        diags.append(q_diag)
        light_vis = {settings.shadow_light: vis}
    with stage_scope("frame.shade"):
        ldr3, _, _ = _shade(px, materials, scene.lights, view_block,
                            frame_params, view, kernels, light_vis, ibl,
                            diags)
    spheres = (settings.show_lights and overlay is not None
               and scene.lights.num_lights > 0)
    ldr = ldr3
    if compact_ids is not None or spheres:
        ldr = _ldr_planes(ldr3, compact_ids, nt)
    if spheres:
        view_proj = m3.matmul(view_block.proj, view_block.view)
        ldr, sp_diag = _composite_light_spheres(
            ldr, zkey, scene.lights, overlay, view_proj, band_settings,
            kernels, band=band)
        diags.append(sp_diag)
    img3 = tuple(_untile(c, view) for c in ldr)
    if gizmo is not None:
        hit, rgb, gz_diag = gizmo
        img3 = _gizmo_into(img3, hit, rgb, settings.width, y0)
        if k == 0:  # the band that holds the gizmo's first row
            diags.append(gz_diag)
    if settings.srgb_output:
        out3 = tuple(srgb_encode(c) for c in img3)
    else:
        out3 = tuple(torch.clamp(c, 0.0, 1.0) for c in img3)
    rows = to_u8(torch.stack(out3, dim=-1))
    if validation_active():
        check_frame_output({"image": rows, "ldr": torch.stack(img3, dim=-1)})
    total = fused.sum_diags(diags)
    return rows, torch.stack([d.to(torch.int32).reshape(()) for d in total])


def _gather(mesh, rows: torch.Tensor, counts: torch.Tensor):
    """Across the ranks: every band's rows in band order, and the drop
    counts summed (one all-gather, one all-reduce; on host tensors for
    gloo)."""
    import torch.distributed as dist

    cdev = mesh.collective_device
    c = counts.to(cdev)
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=mesh.group)
    r = rows.to(cdev).contiguous()
    parts = [torch.empty_like(r) for _ in range(mesh.n_bands)]
    dist.all_gather(parts, r, group=mesh.group)
    return torch.cat(parts).to(rows.device), c.to(rows.device)


def render_frame_sharded(mesh, scene: SceneData, view_block: ViewBlock,
                         frame_params: FrameParams, materials,
                         settings: RenderSettings,
                         overlay: OverlayResources | None = None, ibl=None,
                         check: bool = True, return_diag: bool = False,
                         band_settings: RenderSettings | None = None,
                         kernels: Kernels = KERNELS):
    """Render one frame with its horizontal bands over ``mesh``.

    Returns the (H, W, 3) uint8 image: in one process on the device of
    the first band, across ranks on every rank's own device. The shadow
    map is built once per device from the full scene (its BinDiag
    checked as "sharded shadow pass"); IBL shades within each band.

    The drop counts of every band (main pass, band compaction, shadow
    lookups, the sampling router, light spheres, the gizmo) are summed —
    across ranks by one all-reduce; ``check`` raises on any drop, and
    ``return_diag`` returns (image, BinDiag) instead. ``band_settings``:
    the bands' caps (``autotune_settings_sharded``); without them the
    frame's ``raster_tile_cap`` and ``live_tile_cap`` are scaled to a
    band with slack (:func:`_band_cap`). ``kernels``: as in
    ``render_frame``."""
    if settings.shading != "pbr":
        raise NotImplementedError(
            "render_frame_sharded shards the PBR frame; render flat "
            "scenes with render_frame")
    if settings.gbuffer_viz != GBufferViz.RENDERED_SCENE:
        raise NotImplementedError(
            "G-buffer views are debug views; render them with render_frame")
    check_supported(settings, materials)
    if settings.show_gizmo and overlay is not None \
            and overlay.gizmo_tris is None:
        raise ValueError("show_gizmo needs OverlayResources with a gizmo "
                         "mesh")
    n = mesh.n_bands
    band_h = band_height(settings, n)
    band_nt = settings.tiles_x * (band_h // settings.tile_h)
    if band_settings is not None:
        band_live_cap = band_settings.live_tile_cap
    else:
        band_settings = dataclasses.replace(
            settings, raster_tile_cap=_band_cap(settings.raster_tile_cap, n,
                                                band_nt))
        band_live_cap = _band_cap(settings.live_tile_cap, n, band_nt)
    shadows = settings.enable_shadows and scene.lights.num_lights > 0

    by_device: dict = {}
    for k in mesh.local_bands:
        by_device.setdefault(mesh.devices[k], []).append(k)
    rows, counts = {}, []
    for dev, bands in by_device.items():
        # The kernels launch on the current device's streams.
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            sc, vb, fp, mats, ov, ib = _to(
                (scene, view_block, frame_params, materials, overlay, ibl),
                dev)
            smap = gizmo = None
            if shadows:
                smap, sh_diag = _shadow_map_any(_assemble(sc, vb, settings),
                                                sc, settings, kernels)
                check_bin_diag(sh_diag, where="sharded shadow pass")
            if settings.show_gizmo and ov is not None:
                gizmo = _render_gizmo(vb.view, vb.proj, ov, settings,
                                      kernels)
            for k in bands:
                rows[k], c = _band_rows(k, band_h, sc, vb, fp, mats,
                                        settings, band_settings,
                                        band_live_cap, ov, ib, smap, gizmo,
                                        kernels)
                counts.append(c)
    out_dev = mesh.devices[mesh.local_bands[0]]
    img = torch.cat([rows[k].to(out_dev) for k in mesh.local_bands])
    total = torch.stack([c.to(out_dev) for c in counts]).sum(
        dim=0, dtype=torch.int32)
    if mesh.group is not None:
        img, total = _gather(mesh, img, total)
    img = img[:settings.height]
    diag = fused.BinDiag(*total.unbind())
    if validation_active():
        check_frame_output({"image": img})
    if check:
        check_bin_diag(diag, where="sharded frame")
    if return_diag:
        return img, diag
    return img


class ShardedRenderer:
    """Autotuned band-sharded frames with the drop watcher's re-probe.

    The first frame probes the scene and camera band by band and derives
    the worst band's caps (``autotune_settings_sharded``). A later frame
    whose summed BinDiag reports drops (the camera swung geometry into one
    band past the probed margin) is probed again at that camera, the
    fresh caps merged with the old ones so that they only grow
    (``grow_caps``), and rendered again; a frame that still drops
    raises."""

    def __init__(self, mesh, settings: RenderSettings, materials,
                 overlay: OverlayResources | None = None, ibl=None,
                 margin: float = 1.25, kernels: Kernels = KERNELS):
        self.mesh = mesh
        self.base_settings = settings
        self.materials = materials
        self.overlay = overlay
        self.ibl = ibl
        self.margin = margin
        self.kernels = kernels
        self.retunes = 0
        self._frame: RenderSettings | None = None
        self._band: RenderSettings | None = None

    def _tune(self, scene: SceneData, view_block: ViewBlock) -> None:
        frame, band, _ = autotune_settings_sharded(
            scene, view_block, self.base_settings,
            n_bands=self.mesh.n_bands, margin=self.margin,
            overlay=self.overlay, materials=self.materials,
            kernels=self.kernels)
        if self._band is not None:
            band = grow_caps(self._band, band)
            frame = grow_caps(self._frame, frame)
        self._frame, self._band = frame, band
        self.retunes += 1

    def render(self, scene: SceneData, view_block: ViewBlock,
               frame_params: FrameParams) -> torch.Tensor:
        """Render one frame; returns the (H, W, 3) uint8 image."""
        if self._band is None:
            self._tune(scene, view_block)
        img, diag = render_frame_sharded(
            self.mesh, scene, view_block, frame_params, self.materials,
            self._frame, overlay=self.overlay, ibl=self.ibl, check=False,
            return_diag=True, band_settings=self._band,
            kernels=self.kernels)
        if _diag_has_drops(diag):
            log_info("sharded frame reported dropped geometry — "
                     "re-probing band capacities")
            self._tune(scene, view_block)
            img = render_frame_sharded(
                self.mesh, scene, view_block, frame_params, self.materials,
                self._frame, overlay=self.overlay, ibl=self.ibl, check=True,
                band_settings=self._band, kernels=self.kernels)
        return img
