"""Capacity derivation — measure a frame, set the caps (port of
``bibim_tpu.pipeline.autotune`` as far as the ported frames use it).

Every compaction of the frame is a validated capacity: ``max_candidates ×
raster_passes``, ``pair_budget``, ``live_tile_cap``, ``raster_tile_cap``,
``overflow_cap``, ``dense_tile_cap``, ``group_pair_cap``.

1. :func:`probe_frame_caps` bins the frame's main pass with open
   capacities (and rasterizes it with open windows for the exact covered
   tiles) and reads its demands as host ints (:class:`CapProbe`).
2. :func:`derive_settings` turns them into capacities with a margin,
   rounded up to coarse buckets — pure integer Python, the JAX package's
   rules line for line, so one probe gives the same settings in both.
3. :func:`dense_cap_candidates` + :func:`pick_measured` choose the dense-pass
   slot count of merged multi-pass frames by measurement.

Not ported yet: the escape-tile probe of pair sampling, the overlay
(light-sphere and gizmo) caps' derivation, the shadow pass's derivation,
the band probes of the sharded renderer; :func:`autotune_settings`
raises NotImplementedError where a frame would need one of them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops.geometry import assemble_scene_planar
from bibim_tpu_torch.ops.raster import triangle_setup_planar
from bibim_tpu_torch.pipeline.framegraph import (
    KERNELS,
    Kernels,
    _assemble_and_raster,
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
    escape_tiles: int = -1  # -1: not probed (pair sampling is not ported)


def _bin_stats(setup, settings, width: int, height: int, sort) -> dict:
    """Binning demand statistics of one setup (0-dim tensors): open
    binning at the production span_cap, at subtile granularity under
    ``fine_bins`` (window stats reduce back to coarse tiles)."""
    n_tris = setup.valid.shape[0]
    tiles_x = -(-width // settings.tile_w)
    nsub = fused.NSUB_FINE if settings.fine_bins else 1
    (_, _, counts_b, big_ids, n_big, _, tiles_y, _) = fused.bin_pairs(
        setup, tiles_x * settings.tile_w if nsub > 1 else width, height,
        settings.tile_h, settings.tile_w // nsub, span_cap=settings.span_cap,
        overflow_cap=max(64, min(n_tris, 1 << 14)), max_candidates=1 << 22,
        pair_budget=None, sort=sort)
    nt = tiles_y * tiles_x
    i32 = torch.int32
    total_pairs = counts_b.sum(dtype=i32)
    counts = (counts_b if nsub == 1
              else counts_b.reshape(nt, nsub).sum(dim=1, dtype=i32))
    # Pass-0 liveness includes the overflow triangles' conservative cover;
    # the cover test reads the 15 coverage coefficients of their rows.
    big_valid = big_ids >= 0
    bidx = torch.clamp(big_ids, min=0).long()
    cols = [getattr(setup, name)[k][bidx]
            for name in ("edge_a", "edge_b", "edge_c", "z_coef", "w_coef")
            for k in range(3)]
    ov = torch.zeros((big_ids.shape[0], fused.REC_CH), dtype=torch.float32,
                     device=big_ids.device)
    ov[:, :15] = torch.stack(cols, dim=1) * big_valid.to(torch.float32)[
        :, None]
    live0 = (counts > 0) | fused._big_cover_mask(
        ov, big_ids, nt, tiles_x, settings.tile_h, settings.tile_w)
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
                     measure_coverage: bool = True,
                     kernels: Kernels = KERNELS) -> CapProbe:
    """Measure one frame's capacity demands through ``kernels``.
    ``measure_coverage=False`` skips the raster and bounds coverage by the
    bin-live tiles."""
    width, height = settings.width, settings.height
    psoup = assemble_scene_planar(scene.batches, view_block.view,
                                  view_block.proj, settings.batch_material_ids)
    setup = triangle_setup_planar(psoup.clip, width, height)
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
        out["covered_tiles"] = (px.tri_id >= 0).any(dim=1).sum(
            dtype=torch.int32)
    out = {k: int(v) for k, v in out.items()}
    nt = (-(-settings.width // settings.tile_w)
          * -(-settings.height // settings.tile_h))
    return CapProbe(
        n_tiles=nt,
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
    )


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


def derive_settings(settings, probe: CapProbe, margin: float = 1.25):
    """RenderSettings with capacities derived from a :class:`CapProbe`
    (the JAX package's rules; ``margin`` is headroom for camera motion —
    an underestimate still fails loudly through BinDiag)."""
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
    for k, big_k, pairs_k in probe.span_big:
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
                      kernels: Kernels = KERNELS):
    """Probe + derive in one call. Returns (settings, probe).

    When the derivation picks another span_cap, the bin statistics are
    probed again at that span (coverage is span-independent). The parts
    that are not ported raise NotImplementedError: ``pair_sampling`` (the
    escape-tile probe), light spheres with lights (the overlay caps'
    derivation) and shadows (the light-view derivation)."""
    lights = getattr(scene, "lights", None)
    has_lights = lights is not None and lights.num_lights > 0
    if settings.pair_sampling:
        raise NotImplementedError("autotune with pair_sampling (the "
                                  "escape-tile probe) is not ported")
    if settings.show_lights and has_lights:
        raise NotImplementedError("autotune of the light-sphere overlay "
                                  "caps is not ported")
    if settings.enable_shadows and has_lights:
        raise NotImplementedError("autotune of the shadow pass is not "
                                  "ported")
    probe = probe_frame_caps(scene, view_block, settings, kernels=kernels)
    derived = derive_settings(settings, probe, margin=margin)
    if derived.span_cap != settings.span_cap:
        base2 = dataclasses.replace(settings, span_cap=derived.span_cap)
        probe2 = probe_frame_caps(scene, view_block, base2,
                                  measure_coverage=False, kernels=kernels)
        probe = probe2._replace(covered_tiles=probe.covered_tiles,
                                escape_tiles=probe.escape_tiles)
        derived = derive_settings(base2, probe, margin=margin)
    return derived, probe
