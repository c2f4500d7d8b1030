"""Capacity derivation — measure a frame, set the caps (port of
``bibim_tpu.pipeline.autotune``, single-card).

Every compaction of the frame is a validated capacity: ``max_candidates ×
raster_passes``, ``pair_budget``, ``live_tile_cap``, ``raster_tile_cap``,
``overflow_cap``, ``dense_tile_cap``, ``group_pair_cap``, the sampling
router's ``sample_route_caps``, the overlay's and the shadow pass's caps.

1. :func:`probe_frame_caps` bins the frame's main pass with open
   capacities (and rasterizes it with open windows for the exact covered
   tiles and, with pair sampling, the escape tiles) and reads its demands
   as host ints (:class:`CapProbe`).
2. :func:`derive_settings` turns them into capacities with a margin,
   rounded up to coarse buckets — pure integer Python, the JAX package's
   rules line for line, so one probe gives the same settings in both;
   it also decides whether pair-sampling routing pays.
3. :func:`derive_overlay_tiles` / :func:`derive_overlay_caps` size the
   light-sphere composite and the corner gizmo, and
   :func:`derive_shadow_settings` the light-view pass, each from its own
   binning probe; :func:`autotune_settings` runs them all, and
   :func:`grow_caps` merges a fresh derivation into earlier settings.
4. :func:`dense_cap_candidates` + :func:`pick_measured` choose the
   dense-pass slot count of merged multi-pass frames by measurement.
5. :func:`probe_band_caps` / :func:`autotune_settings_sharded`: the same
   for the band-sharded renderer (``parallel.tile_shard``), each band
   probed with the band setup its render runs, the caps derived from the
   worst band.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops import shadow as sh
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.geometry import assemble_scene_planar
from bibim_tpu_torch.ops.raster import triangle_setup, triangle_setup_planar
from bibim_tpu_torch.pipeline.framegraph import (
    KERNELS,
    Kernels,
    _assemble_and_raster,
    _gizmo_clip,
    _light_clip_planar,
    _light_sphere_planar_soup,
    _main_setup,
    _shadow_fit_ranges,
)


class CapProbe(NamedTuple):
    """One frame's measured capacity demands (host ints)."""

    n_tiles: int  # total screen tiles
    bin_tiles: int  # tiles with binned candidates or big-triangle cover
    covered_tiles: int  # raster-covered tiles (== bin_tiles unprobed)
    max_candidates: int  # worst tile's candidate count
    total_pairs: int  # live (tile, triangle) pairs
    n_big: int  # triangles routed to the shared overflow list
    # ((span, n_big, pairs), ...) per candidate span_cap 2/4/8/16.
    span_big: tuple = ()
    n_tris: int = 0
    dense_tiles: int = 0  # tiles denser than one 512-candidate window
    group_win: int = 0  # worst 8-consecutive-live-tile candidate window
    small_pair_frac: float = 0.0  # share of pairs from subtile-sized tris
    # Tiles where a covered pixel escapes its pair-sampling group's texel
    # window (sizes sample_route_caps); -1: not probed (needs materials).
    escape_tiles: int = -1


def _open_bins(setup, width: int, height: int, tile_h: int, bin_w: int,
               span_cap: int, sort, overflow_cap: int | None = None):
    """``fused.bin_pairs`` with open capacities (nothing clamps)."""
    n_tris = setup.valid.shape[0]
    return fused.bin_pairs(
        setup, width, height, tile_h, bin_w, span_cap=span_cap,
        overflow_cap=overflow_cap or max(64, min(n_tris, 1 << 14)),
        max_candidates=1 << 22, pair_budget=None, sort=sort)


def _cover_live(setup, counts, big_ids, nt: int, tiles_x: int, tile_h: int,
                tile_w: int, y0: int = 0) -> torch.Tensor:
    """(NT,) pass-0 live tiles: binned candidates or an overflow
    triangle's conservative cover (the test reads the 15 coverage
    coefficients of its row; in a band that starts at frame row ``y0``,
    over the band's tiles in frame rows, as the band's raster tests
    it)."""
    big_valid = big_ids >= 0
    bidx = torch.clamp(big_ids, min=0).long()
    cols = [getattr(setup, name)[k][bidx]
            for name in ("edge_a", "edge_b", "edge_c", "z_coef", "w_coef")
            for k in range(3)]
    ov = torch.zeros((big_ids.shape[0], fused.REC_CH), dtype=torch.float32,
                     device=big_ids.device)
    ov[:, :15] = torch.stack(cols, dim=1) * big_valid.to(torch.float32)[
        :, None]
    return (counts > 0) | fused._big_cover_mask(ov, big_ids, nt, tiles_x,
                                                tile_h, tile_w,
                                                y0 // tile_h)


def _bin_stats(setup, settings, width: int, height: int, sort,
               y0: int = 0) -> dict:
    """Binning demand statistics of one setup (0-dim tensors): open
    binning at the production span_cap, at subtile granularity under
    ``fine_bins`` (window stats reduce back to coarse tiles); ``y0``: the
    first frame row of a band's setup."""
    n_tris = setup.valid.shape[0]
    tiles_x = -(-width // settings.tile_w)
    nsub = fused.NSUB_FINE if settings.fine_bins else 1
    (_, _, counts_b, big_ids, n_big, _, tiles_y, _) = _open_bins(
        setup, tiles_x * settings.tile_w if nsub > 1 else width, height,
        settings.tile_h, settings.tile_w // nsub, settings.span_cap, sort)
    nt = tiles_y * tiles_x
    i32 = torch.int32
    total_pairs = counts_b.sum(dtype=i32)
    counts = (counts_b if nsub == 1
              else counts_b.reshape(nt, nsub).sum(dim=1, dtype=i32))
    live0 = _cover_live(setup, counts, big_ids, nt, tiles_x,
                        settings.tile_h, settings.tile_w, y0)
    bin_live = live0.sum(dtype=i32)
    bx0, by0, bx1, by1 = setup.bbox
    bin_w = settings.tile_w // nsub
    area = (((bx1 // bin_w) - (bx0 // bin_w) + 1)
            * ((by1 // settings.tile_h) - (by0 // settings.tile_h) + 1))
    zero = torch.zeros_like(area)
    stats = {}
    for k in (2, 4, 8, 16):
        stats[f"span{k}_big"] = (setup.valid & (area > k)).sum(dtype=i32)
        stats[f"span{k}_pairs"] = torch.where(
            setup.valid & (area <= k), area, zero).sum(dtype=i32)
    sub_small = (setup.valid
                 & (bx1 - bx0 < settings.tile_w // fused.NSUB_FINE)
                 & (by1 - by0 < settings.tile_h))
    stats["small_pairs"] = torch.where(sub_small, area, zero).sum(dtype=i32)
    # Worst sum over 8 consecutive live tiles of the compact list (the
    # group window's budget).
    ids_all, _ = fused._compact_tile_list(live0, nt)
    c_live = torch.where(
        torch.arange(nt, device=counts.device) < bin_live,
        counts[ids_all.long()], torch.zeros_like(counts))
    pad = (-nt) % 8
    if pad:
        c_live = torch.cat([c_live, torch.zeros(pad, dtype=c_live.dtype,
                                                device=c_live.device)])
    return {
        "n_tris": n_tris,
        "bin_tiles": bin_live,
        "max_candidates": counts.max(),
        "total_pairs": total_pairs,
        "n_big": n_big[0],
        "covered_tiles": bin_live,
        "group_win": c_live.reshape(-1, 8).sum(dim=1, dtype=i32).max(),
        "dense_tiles": (counts > 512).sum(dtype=i32),
        **stats,
    }


def probe_frame_caps(scene, view_block, settings,
                     measure_coverage: bool = True, esc_probe=None,
                     kernels: Kernels = KERNELS) -> CapProbe:
    """Measure one frame's capacity demands through ``kernels``.
    ``measure_coverage=False`` skips the raster and bounds coverage by the
    bin-live tiles. ``esc_probe`` = (pair level, ((h, w), ...) of the
    block tables) adds the sampling router's escape tiles (needs the
    raster)."""
    width, height = settings.width, settings.height
    _, setup = _main_setup(scene, view_block, settings)
    out = _bin_stats(setup, settings, width, height, kernels.sort)
    if measure_coverage:
        # Exact shaded coverage: the production main pass with open
        # capacities.
        open_settings = dataclasses.replace(
            settings, max_candidates=1024, raster_passes=8,
            span_cap=settings.span_cap, overflow_cap=512,
            pair_budget=1 << 21, live_tile_cap=None, raster_tile_cap=None,
            xla_cap=max(settings.xla_cap, 2048))
        px, _, _, _ = _assemble_and_raster(scene, view_block, open_settings,
                                           kernels)
        valid = px.tri_id >= 0
        out["covered_tiles"] = valid.any(dim=1).sum(dtype=torch.int32)
        if esc_probe:
            # Tiles where group-rate block sampling would clamp a covered
            # pixel's footprint (framegraph._sampled_ldr routes them).
            pair, shapes = esc_probe
            u, v = px.uv
            flags = None
            for (h, w) in shapes:
                f = tq.escape_tiles_hw(h, w, u, v, valid, pair,
                                       settings.tile_w)
                flags = f if flags is None else flags | f
            out["escape_tiles"] = flags.sum(dtype=torch.int32)
    out = {k: int(v) for k, v in out.items()}
    nt = (-(-settings.width // settings.tile_w)
          * -(-settings.height // settings.tile_h))
    return _cap_probe(out, nt)


def _cap_probe(out: dict, n_tiles: int) -> CapProbe:
    """A :class:`CapProbe` of :func:`_bin_stats`' host ints."""
    return CapProbe(
        n_tiles=n_tiles,
        bin_tiles=out["bin_tiles"],
        covered_tiles=out["covered_tiles"],
        max_candidates=out["max_candidates"],
        total_pairs=out["total_pairs"],
        n_big=out["n_big"],
        span_big=tuple((k, out[f"span{k}_big"], out[f"span{k}_pairs"])
                       for k in (2, 4, 8, 16)),
        n_tris=out["n_tris"],
        group_win=out["group_win"],
        dense_tiles=out["dense_tiles"],
        small_pair_frac=out["small_pairs"] / max(out["total_pairs"], 1),
        escape_tiles=out.get("escape_tiles", -1),
    )


def band_height(settings, n_bands: int) -> int:
    """Rows of each of ``n_bands`` horizontal bands: the frame height
    split evenly, rounded up to whole tiles (the last band may reach past
    the frame; the sharded frame crops it)."""
    rows = -(-settings.height // n_bands)
    return -(-rows // settings.tile_h) * settings.tile_h


def probe_band_caps(scene, view_block, settings, n_bands: int,
                    kernels: Kernels = KERNELS) -> CapProbe:
    """Worst-band capacity demands of the band-sharded renderer: every
    band probed with the band setup its render runs (bounding boxes in
    band rows), binned open at band height; each demand is the maximum
    over bands, so that every band takes the same caps. Coverage is
    bounded by the bin-live tiles (no raster probe); the sharded frame's
    summed BinDiag validates the caps.

    Unlike the JAX package's, an overflow triangle's tile cover is tested
    over the band's own tiles: the JAX package tests the frame's first
    rows instead (band-local rows against frame coefficients), which
    undercounts the live tiles of a lower band that a big triangle covers
    (the 100× ground plane at 1080p on 4 bands: 306 bin-live tiles probed
    against 510 in the bottom band, so every frame dropped 126 tiles)."""
    band_h = band_height(settings, n_bands)
    outs = []
    for b in range(n_bands):
        _, setup = _main_setup(scene, view_block, settings,
                               band=(band_h, b * band_h))
        o = _bin_stats(setup, settings, settings.width, band_h,
                       kernels.sort, y0=b * band_h)
        outs.append({k: int(v) for k, v in o.items()})
    worst = {k: max(o[k] for o in outs) for k in outs[0]}
    return _cap_probe(worst, settings.tiles_x * (band_h // settings.tile_h))


def autotune_settings_sharded(scene, view_block, settings, n_bands: int,
                              margin: float = 1.25, overlay=None,
                              materials=None, kernels: Kernels = KERNELS):
    """Probe + derive for the band-sharded renderer. The frame's autotune
    first (span routing, the sampling router's decision and route caps,
    shadow and overlay caps: band-independent, or full-frame bounds the
    bands reuse; with ``materials`` it measures coverage and escape
    tiles), then the bands probed at the chosen span and the band caps
    derived from the worst band; if that picks a smaller span, the bands
    are probed again at it. Returns ``(frame_settings, band_settings,
    band_probe)``: the frame settings drive the passes outside the bands
    (shadow map, gizmo), the band settings ``render_frame_sharded``'s
    ``band_settings``."""
    derived, _ = autotune_settings(scene, view_block, settings,
                                   margin=margin,
                                   measure_coverage=materials is not None,
                                   materials=materials, overlay=overlay,
                                   kernels=kernels)
    base = dataclasses.replace(settings, span_cap=derived.span_cap)
    probe = probe_band_caps(scene, view_block, base, n_bands, kernels)
    band = derive_settings(derived, probe, margin=margin)
    if band.span_cap != derived.span_cap:
        base = dataclasses.replace(settings, span_cap=band.span_cap)
        probe = probe_band_caps(scene, view_block, base, n_bands, kernels)
        band = derive_settings(
            dataclasses.replace(derived, span_cap=band.span_cap), probe,
            margin=margin)
    return derived, band, probe


# Capacities where None means "uncapped" (None wins a merge), and the
# ones that are plain ints; the dense-pass grid size (None: no dense pass)
# is merged apart.
_CAPS_NONE_UNCAPPED = ("live_tile_cap", "raster_tile_cap")
_CAPS_INT = ("max_candidates", "raster_passes", "overflow_cap",
             "pair_budget", "overlay_candidates", "overlay_max_tiles",
             "overlay_overflow_cap")


def grow_caps(old, new):
    """A fresh derivation merged into earlier settings with the caps only
    ever growing (a camera oscillating across a bucket edge must not
    thrash); routing choices (span_cap, span_mid_cap, merged_coverage)
    take the fresh derivation, their overflow validated apart."""
    merged = {k: max(getattr(old, k), getattr(new, k)) for k in _CAPS_INT}
    for k in _CAPS_NONE_UNCAPPED:
        a, b = getattr(old, k), getattr(new, k)
        merged[k] = None if (a is None or b is None) else max(a, b)
    a, b = old.dense_tile_cap, new.dense_tile_cap
    merged["dense_tile_cap"] = (
        max((c for c in (a, b) if c is not None), default=None)
        if merged["raster_passes"] > 1 else None)
    return dataclasses.replace(new, **merged)


def _probe_shadow(scene, view_block, settings, kernels: Kernels) -> dict:
    """Light-view binning demands (the front half of the frame's shadow
    pass, binned with open capacities) and the screen tiles whose covered
    pixels land inside the light frustum (the PCF footprint), as host
    ints."""
    size = settings.shadow_size
    psoup = assemble_scene_planar(scene.batches, view_block.view,
                                  view_block.proj, settings.batch_material_ids)
    lvp, clip_l = _light_clip_planar(psoup, scene.lights, settings,
                                     _shadow_fit_ranges(scene, settings))
    setup_l = triangle_setup_planar(clip_l, size, size)
    (_, _, counts, big_ids, n_big, _, tiles_y, tiles_x) = _open_bins(
        setup_l, size, size, settings.tile_h, settings.tile_w,
        settings.span_cap, kernels.sort)
    live0 = _cover_live(setup_l, counts, big_ids, tiles_y * tiles_x,
                        tiles_x, settings.tile_h, settings.tile_w)
    open_settings = dataclasses.replace(
        settings, max_candidates=1024, raster_passes=8, overflow_cap=512,
        pair_budget=1 << 21, live_tile_cap=None, raster_tile_cap=None,
        enable_shadows=False, xla_cap=max(settings.xla_cap, 2048))
    px, _, _, _ = _assemble_and_raster(scene, view_block, open_settings,
                                       kernels)
    cx, cy, cz = sh._light_clip(sh.ShadowMap(None, lvp, size), px.world)
    q_live = (sh._inside_frustum(cx, cy, cz) & (px.tri_id >= 0)).any(dim=1)
    return {"max_candidates": int(counts.max()),
            "total_pairs": int(counts.sum()), "n_big": int(n_big[0]),
            "live_tiles": int(live0.sum()), "query_tiles": int(q_live.sum())}


def derive_shadow_settings(scene, view_block, settings,
                           margin: float = 1.25,
                           kernels: Kernels = KERNELS):
    """The shadow pass's capacities from a light-view probe
    (shadow_candidates / shadow_passes, shadow_tile_cap,
    shadow_query_tile_cap; pair_budget and overflow_cap raised where the
    light view demands more than the main camera). A light projection
    concentrates the scene into a few map tiles, so the grid is compacted
    and the windows sized to the worst tile; every cap stays validated
    by the shadow pass's BinDiag."""
    out = _probe_shadow(scene, view_block, settings, kernels)
    nt = (-(-settings.shadow_size // settings.tile_w)
          * -(-settings.shadow_size // settings.tile_h))
    mc = _bucket(int(out["max_candidates"] * margin), floor=64)
    passes = 1
    if mc > 1024:
        passes = -(-mc // 1024)
        mc = 1024
    tcap = _bucket(int(out["live_tiles"] * margin) + 8, floor=64)
    nt_screen = settings.tiles_x * settings.tiles_y
    qcap = _bucket(int(out["query_tiles"] * margin) + 8, floor=64)
    return dataclasses.replace(
        settings,
        shadow_candidates=mc,
        shadow_passes=passes,
        shadow_tile_cap=tcap if tcap < nt else None,
        shadow_query_tile_cap=qcap if qcap < nt_screen else None,
        pair_budget=max(settings.pair_budget,
                        _bucket(int(out["total_pairs"] * margin),
                                floor=4096)),
        overflow_cap=max(settings.overflow_cap,
                         _bucket(int(out["n_big"] * margin) + 16,
                                 floor=64)),
    )


def _probe_overlay(lights, overlay, view_proj, settings, sort) -> dict:
    """Binning demands of the light-sphere composite: the same binning
    the frame's ``_composite_light_spheres`` runs (span_cap 32), open."""
    w, h = settings.width, settings.height
    soup = _light_sphere_planar_soup(lights, overlay, view_proj)
    setup = triangle_setup_planar(soup.clip, w, h)
    (_, _, counts, big_ids, n_big, _, tiles_y, tiles_x) = _open_bins(
        setup, w, h, settings.tile_h, settings.tile_w, 32, sort)
    live = _cover_live(setup, counts, big_ids, tiles_y * tiles_x, tiles_x,
                       settings.tile_h, settings.tile_w)
    return {"max_candidates": int(counts.max()), "n_big": int(n_big[0]),
            "live_tiles": int(live.sum())}


def _probe_gizmo(view_block, overlay, settings, sort) -> int:
    """Worst-tile candidates of the corner-gizmo raster, which binds the
    same ``overlay_candidates`` window as the sphere composite."""
    ext = settings.gizmo_extent
    clip, _ = _gizmo_clip(view_block.view, view_block.proj, overlay)
    setup = triangle_setup(clip, overlay.gizmo_tris, ext, ext)
    (_, _, counts, _, _, _, _, _) = _open_bins(
        setup, ext, ext, settings.tile_h, settings.tile_w, settings.span_cap,
        sort, overflow_cap=max(64, overlay.gizmo_tris.shape[0]))
    return int(counts.max())


def _has_lights(scene) -> bool:
    lights = getattr(scene, "lights", None)
    return lights is not None and lights.num_lights > 0


def derive_overlay_caps(scene, view_block, settings, overlay,
                        margin: float = 1.25,
                        kernels: Kernels = KERNELS) -> dict:
    """Probe-derived ``overlay_candidates`` (the worst demand of every
    pass that binds it: the light-sphere composite and the corner gizmo),
    ``overlay_max_tiles`` and ``overlay_overflow_cap``; all floored at 64
    and validated by the overlay's BinDiag."""
    out: dict = {}
    demands = []
    if settings.show_lights and _has_lights(scene):
        vp = m3.matmul(view_block.proj, view_block.view)
        p = _probe_overlay(scene.lights, overlay, vp, settings, kernels.sort)
        demands.append(p["max_candidates"])
        out["overlay_max_tiles"] = _bucket(
            int(p["live_tiles"] * margin) + 8, floor=64)
        out["overlay_overflow_cap"] = max(
            settings.overlay_overflow_cap,
            _bucket(int(p["n_big"] * margin) + 8, floor=64))
    if settings.show_gizmo:
        demands.append(_probe_gizmo(view_block, overlay, settings,
                                    kernels.sort))
    if demands:
        out["overlay_candidates"] = _bucket(
            int(max(demands) * margin) + 8, floor=64)
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def derive_overlay_tiles(lights_pos, view, proj, settings,
                         radius: float = 0.1, margin: float = 1.5) -> int:
    """Conservative screen-tile bound of the light-sphere composite (the
    r = 0.1 spheres at the lights): each light's AABB corners projected
    on the host; a sphere straddling the near plane bounds it by the
    whole screen."""
    nt = settings.tiles_x * settings.tiles_y
    vp = _host(proj) @ _host(view)
    tiles = 0
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
         for sz in (-1, 1)], np.float64) * radius
    for p in _host(lights_pos):
        pts = p[None, :] + corners  # (8, 3)
        hc = np.concatenate([pts, np.ones((8, 1))], axis=1) @ vp.T
        if (hc[:, 3] <= 1e-6).any():
            return nt
        ndc = hc[:, :2] / hc[:, 3:4]
        x = (ndc[:, 0] * 0.5 + 0.5) * settings.width
        y = (ndc[:, 1] * 0.5 + 0.5) * settings.height

        def span(c, tile, n):
            return (int(np.clip(np.floor(c.min() / tile), 0, n - 1)),
                    int(np.clip(np.floor(c.max() / tile), 0, n - 1)))

        x0, x1 = span(x, settings.tile_w, settings.tiles_x)
        y0, y1 = span(y, settings.tile_h, settings.tiles_y)
        if (x.max() >= 0 and x.min() < settings.width
                and y.max() >= 0 and y.min() < settings.height):
            tiles += (x1 - x0 + 1) * (y1 - y0 + 1)
    return min(_bucket(int(tiles * margin) + 8, floor=64), nt)


def dense_cap_candidates(settings, probe: CapProbe,
                         margin: float = 1.25) -> tuple:
    """``dense_tile_cap`` candidates of a merged multi-pass frame: the
    derived cap and the 2× variant, for :func:`pick_measured` (a schedule
    choice above the measured demand; every candidate is validated by
    ``dropped_tiles``)."""
    if not settings.merged_coverage or settings.dense_tile_cap is None:
        return (settings,)
    alt = min(_bucket(int(2 * probe.dense_tiles * margin), floor=64),
              probe.n_tiles)
    if alt == settings.dense_tile_cap:
        return (settings,)
    return (settings, dataclasses.replace(settings, dense_tile_cap=alt))


def pick_measured(candidates, measure):
    """The fastest of several validated settings by ``measure(settings) ->
    ms``. Returns ``(best_settings, [(ms, settings), ...])``."""
    results = [(float(measure(s)), s) for s in candidates]
    best = min(results, key=lambda r: r[0])
    return best[1], results


def _bucket(x: int, floor: int = 64) -> int:
    """Round up to a coarse grid (granularity ≈ 3 % of magnitude)."""
    x = max(int(x), 1)
    g = max(floor, 1 << max(0, x.bit_length() - 5))
    return -(-x // g) * g


def derive_settings(settings, probe: CapProbe, margin: float = 1.25,
                    keep_span: bool = False):
    """RenderSettings with capacities derived from a :class:`CapProbe`
    (the JAX package's rules; ``margin`` is headroom for camera motion —
    an underestimate still fails loudly through BinDiag). ``keep_span``
    keeps ``settings.span_cap`` (the probe's own) instead of searching
    for a smaller one."""
    mc = _bucket(int(probe.max_candidates * margin), floor=64)
    passes = 1
    if mc > 1024:
        # Dense tiles: depth-chained 512-candidate windows.
        passes = -(-mc // 512)
        mc = 512
    live = _bucket(int(probe.covered_tiles * margin), floor=64)
    raster = _bucket(int(probe.bin_tiles * margin), floor=64)

    # The smallest span_cap that adds almost nothing to the overflow list.
    span_cap = settings.span_cap
    n_big = probe.n_big
    pairs = probe.total_pairs
    for k, big_k, pairs_k in () if keep_span else probe.span_big:
        if (fused.SPAN_DENSE < k < span_cap
                and big_k <= max(32, probe.n_big + 16)):
            span_cap, n_big, pairs = k, big_k, pairs_k
            break

    # Span-class binning when it shrinks the sort input by >= ~25 %.
    span_mid = None
    big_dense = next(
        (b for k2, b, _ in probe.span_big if k2 == fused.SPAN_DENSE), None)
    if big_dense is not None and span_cap > fused.SPAN_DENSE:
        mid_n = max(big_dense - n_big, 0)
        cap = _bucket(int(mid_n * margin) + 16, floor=128)
        t = max(probe.n_tris, 1)
        if t * fused.SPAN_DENSE + cap * span_cap <= 0.75 * t * span_cap:
            span_mid = cap

    # Group window: opt-in (a group_pair_cap in the base settings), single
    # pass, never with fine_bins.
    group_pair = settings.group_pair_cap
    if settings.fine_bins:
        group_pair = None
    if group_pair is not None and passes == 1 and probe.group_win > 0:
        group_pair = _bucket(int(probe.group_win * margin) + 8, floor=64)
    elif passes != 1:
        group_pair = None

    dense_cap = None
    if passes > 1:
        dense_cap = _bucket(int(probe.dense_tiles * margin) + 8, floor=64)

    # Merged coverage on multi-pass frames, except with fine bins or
    # early-z.
    merged = passes > 1 and not settings.fine_bins and not settings.early_z

    live_cap = live if live < probe.n_tiles else None

    route = settings.sample_route_caps
    pair = settings.pair_sampling
    if settings.pair_sampling and probe.escape_tiles >= 0:
        nt_prod = live_cap if live_cap is not None else probe.n_tiles
        esc = min(probe.escape_tiles, nt_prod)
        clean_live = max(int(probe.covered_tiles) - esc, 0)
        if clean_live < max(64, int(probe.covered_tiles) // 4):
            pair = 0
            route = None
        else:
            e_cap = min(_bucket(int(esc * margin) + 8, floor=32), nt_prod)
            q_cap = min(
                _bucket(int((nt_prod - esc) * margin) + 8, floor=32),
                nt_prod)
            route = (q_cap, e_cap)

    return dataclasses.replace(
        settings,
        pair_sampling=pair,
        max_candidates=mc,
        raster_passes=passes,
        merged_coverage=merged,
        dense_tile_cap=dense_cap,
        span_cap=span_cap,
        span_mid_cap=span_mid,
        overflow_cap=_bucket(int(n_big * margin) + 16, floor=64),
        pair_budget=_bucket(int(pairs * margin), floor=4096),
        live_tile_cap=live_cap,
        raster_tile_cap=raster if raster < probe.n_tiles else None,
        group_pair_cap=group_pair,
        sample_route_caps=route,
    )


def autotune_settings(scene, view_block, settings, margin: float = 1.25,
                      measure_coverage: bool = True, materials=None,
                      overlay=None, kernels: Kernels = KERNELS,
                      keep_span: bool = False):
    """Probe + derive in one call. Returns (settings, probe).

    When the derivation picks another span_cap, the bin statistics are
    probed again at that span (coverage is span-independent).
    ``materials``: the frame's binding; with ``pair_sampling`` the probe
    measures the escape tiles of its block tables, which decide the
    routing (only their (height, width) are read). With light spheres on
    and lights in the scene, ``overlay_max_tiles`` takes the projected
    bound (:func:`derive_overlay_tiles`); ``overlay``, the overlay
    resources, replaces it by the composite's and the gizmo's measured
    caps (:func:`derive_overlay_caps`); with shadows, the light-view
    probe sizes the shadow pass (:func:`derive_shadow_settings`).
    ``keep_span``: every cap derived at ``settings.span_cap``
    (:func:`derive_settings`)."""
    esc_probe = None
    if settings.pair_sampling and isinstance(materials, (tuple, list)):
        shapes = tuple((t.height, t.width) for t in materials
                       if isinstance(t, tq.BlockTable))
        if shapes:
            esc_probe = (int(settings.pair_sampling), shapes)
    probe = probe_frame_caps(scene, view_block, settings,
                             measure_coverage=measure_coverage,
                             esc_probe=esc_probe if measure_coverage
                             else None, kernels=kernels)
    derived = derive_settings(settings, probe, margin=margin,
                              keep_span=keep_span)
    if derived.span_cap != settings.span_cap:
        base2 = dataclasses.replace(settings, span_cap=derived.span_cap)
        probe2 = probe_frame_caps(scene, view_block, base2,
                                  measure_coverage=False, kernels=kernels)
        probe = probe2._replace(covered_tiles=probe.covered_tiles,
                                escape_tiles=probe.escape_tiles)
        derived = derive_settings(base2, probe, margin=margin)
    if derived.show_lights and _has_lights(scene):
        n = scene.lights.num_lights
        derived = dataclasses.replace(derived, overlay_max_tiles=min(
            derived.overlay_max_tiles,
            derive_overlay_tiles(scene.lights.pos[:n], view_block.view,
                                 view_block.proj, derived)))
    if overlay is not None:
        derived = dataclasses.replace(derived, **derive_overlay_caps(
            scene, view_block, derived, overlay, margin=margin,
            kernels=kernels))
    if derived.enable_shadows and _has_lights(scene):
        derived = derive_shadow_settings(scene, view_block, derived,
                                         margin=margin, kernels=kernels)
    return derived, probe
