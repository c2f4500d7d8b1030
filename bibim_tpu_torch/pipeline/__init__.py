"""The frame function."""

from bibim_tpu_torch.pipeline.framegraph import (
    BLOCK_TABLE_THRESHOLD,
    KERNELS,
    PLAIN,
    FrameParams,
    GBufferViz,
    Kernels,
    OverlayResources,
    RenderSettings,
    ViewBlock,
    check_supported,
    make_overlay_resources,
    material_quads_from_set,
    render_frame,
)

__all__ = [
    "BLOCK_TABLE_THRESHOLD",
    "KERNELS",
    "PLAIN",
    "FrameParams",
    "GBufferViz",
    "Kernels",
    "OverlayResources",
    "RenderSettings",
    "ViewBlock",
    "check_supported",
    "make_overlay_resources",
    "material_quads_from_set",
    "render_frame",
]
