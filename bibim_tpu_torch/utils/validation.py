"""Runtime validation (port of ``bibim_tpu.utils.validation``): the Vulkan
validation-layer analog. Capacity drops, malformed scene data and
non-finite frame outputs are errors, not rendering choices."""

from __future__ import annotations

import contextlib
import contextvars

import torch

_LAYER = contextvars.ContextVar("bibim_validation_layer", default=False)


def bb_assert(condition, message: str) -> None:
    if not condition:
        raise AssertionError(message)


@contextlib.contextmanager
def validation_layer():
    """Within the block, ``render_frame`` and ``render_frame_sharded``
    hold what they return to :func:`check_frame_output` before returning
    it, with the frame's LDR planes before the sRGB encode: an HDR value
    that is not finite reaches them through the tone map (the production
    kernels tone map in their epilogue, so their HDR is never stored)."""
    token = _LAYER.set(True)
    try:
        yield
    finally:
        _LAYER.reset(token)


def validation_active() -> bool:
    """True within :func:`validation_layer`."""
    return _LAYER.get()


def check_scene_data(scene) -> None:
    """Shape contracts of a SceneData: each batch's vertex arrays (V, k)
    with one row per position, (F, 3) indices within them, (I, 4, 4)
    instance matrices; the lights' arrays one row per light, at most
    100 lights."""
    for bi, b in enumerate(scene.batches):
        v = b.positions.shape[0]
        bb_assert(b.positions.dim() == 2 and b.positions.shape[1] == 3,
                  f"batch {bi}: positions must be (V,3)")
        for name in ("uvs", "normals", "tangents", "colors"):
            bb_assert(getattr(b, name).shape[0] == v,
                      f"batch {bi}: {name} count != positions")
        bb_assert(b.indices.dim() == 2 and b.indices.shape[1] == 3,
                  f"batch {bi}: indices must be (F,3)")
        top = int(b.indices.max()) if b.indices.numel() else 0
        bb_assert(top < v, f"batch {bi}: index out of range")
        bb_assert(tuple(b.model.shape[-2:]) == (4, 4)
                  and b.model.shape == b.inv_model.shape,
                  f"batch {bi}: instance matrices must be (I,4,4)")
    lights = scene.lights
    n = lights.pos.shape[0]
    for name in ("type", "dir", "intensity", "color", "inner_cutoff",
                 "outer_cutoff"):
        bb_assert(getattr(lights, name).shape[0] == n,
                  f"lights: {name} count mismatch")
    bb_assert(n <= 100, "MAX_NUM_LIGHTS is 100")


def check_frame_output(out: dict) -> None:
    """Frame invariants: an (H, W, 3) uint8 image; where ``out`` has them,
    depth finite and in [0, 1], and HDR and LDR planes finite."""
    img = out["image"]
    bb_assert(img.dtype == torch.uint8, "image must be uint8")
    bb_assert(img.dim() == 3 and img.shape[-1] == 3,
              "image must be (H, W, 3)")
    if "depth" in out:
        depth = out["depth"]
        bb_assert(bool(torch.isfinite(depth).all()),
                  "depth has non-finite values")
        bb_assert(depth.numel() == 0 or (float(depth.min()) >= 0.0
                                         and float(depth.max()) <= 1.0),
                  "depth out of [0,1]")
    for key, what in (("hdr", "HDR buffer"), ("ldr", "LDR planes")):
        if key in out:
            bb_assert(bool(torch.isfinite(out[key]).all()),
                      f"{what} has NaN/Inf")


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
