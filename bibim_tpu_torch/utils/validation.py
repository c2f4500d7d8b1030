"""Capacity validation (port of ``bibim_tpu.utils.validation.check_bin_diag``):
geometry dropped by a capacity is an error, not a rendering choice."""

from __future__ import annotations


def bb_assert(condition, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def check_bin_diag(diag, where: str = "frame") -> None:
    """Raise with the capacity to raise when ``diag`` reports drops."""
    ov = int(diag.dropped_overflow)
    cap = int(diag.dropped_cap)
    pairs = int(diag.dropped_pairs)
    tiles = int(diag.dropped_tiles)
    bb_assert(ov == 0, f"{where}: {ov} huge triangles dropped — raise "
              "RenderSettings.overflow_cap")
    bb_assert(cap == 0, f"{where}: {cap} tile candidates dropped — raise "
              "RenderSettings.max_candidates (or span_cap if triangles are "
              "being misclassified as huge)")
    bb_assert(pairs == 0, f"{where}: {pairs} (triangle, tile) pairs beyond "
              "the pair budget or the span_mid_cap list — raise "
              "RenderSettings.pair_budget / span_mid_cap")
    bb_assert(tiles == 0, f"{where}: {tiles} live tiles beyond a "
              "compact-grid capacity — raise live_tile_cap, raster_tile_cap, "
              "overlay_max_tiles or dense_tile_cap")
