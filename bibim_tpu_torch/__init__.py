"""bibim_tpu_torch — the PyTorch + CUDA port of the bibim_tpu renderer.

The JAX package ``bibim_tpu`` is the reference; this package mirrors its
layout module for module and runs the deferred PBR frame on an NVIDIA
Hopper card, with the shadow map, image-based lighting, trilinear mips,
and the instanced frame with host culling and the capacity autotune.
Plain tensor code is PyTorch; the kernels of the frame's hot path are
hand-written CUDA C++ (``csrc/``), built with ``nvcc`` into one shared
library at first use (see ``_build.py``):

- K1 raster + resolve        → ``ops.fused.raster_tiles``   (csrc/raster.cu;
  its tail, every candidate past a multi-pass frame's first window, →
  ``ops.fused.raster_tiles_tail``)
- K2 sampled shade           → ``ops.shading.shade_sampled`` (csrc/shade.cu)
- K3 pair sort               → ``ops.sort.sort_keys``       (csrc/sort.cu)
- K4 overlay composite       → ``ops.fused.overlay_tiles``
  (csrc/raster.cu, K1's scan over the live tiles of a compact list)
- K5 G-buffer shade          → ``ops.shading.shade_tonemap``
  (csrc/gbuffer_shade.cu)
- K6 block-table sample      → ``ops.texture_quad.sample_table_block_kernel``
  (csrc/sample.cu)
- K7 small-table sample      → ``ops.texture_quad.sample_rows_small``
  (csrc/sample.cu)
- K8 mip-block sample        → ``ops.texture_quad.sample_mip_block_kernel``
  (csrc/mip_sample.cu)
- K9 early-z raster          → ``ops.fused.raster_tiles_earlyz``
  (csrc/raster_earlyz.cu)
- K10 group-window raster    → ``ops.fused.raster_tiles_gw``
  (csrc/raster.cu, K1's scan over group windows)
- K11 fine-subtile raster    → ``ops.fused.raster_tiles_fine``
  (csrc/raster_fine.cu)

Every kernel wrapper takes its plain PyTorch version for CPU tensors only;
a CUDA tensor reaches the kernel or the wrapper raises. The entry points
that build tensors (scenes, lights, draw batches, material tables, IBL,
overlay resources, the ``interop`` converters) take ``device`` and default
to ``"cuda"``: the frame runs on the card unless the caller asks for the
CPU with ``device="cpu"``, and without a card asking for ``"cuda"`` raises
torch's own error. Importing this package needs neither ``nvcc`` nor a
GPU, and never imports ``jax``.

Layout:

- :mod:`bibim_tpu_torch.math3d`    — matrix conventions (reversed-Z)
- :mod:`bibim_tpu_torch.scene`     — draw batches, lights, camera, scenes,
  host culling
- :mod:`bibim_tpu_torch.assets`    — FBX / OBJ / image / PBR-set loaders
- :mod:`bibim_tpu_torch.ops`       — geometry, setup, binning, kernels,
  texture tables, shading, shadow map, IBL, tone mapping
- :mod:`bibim_tpu_torch.pipeline`  — ``render_frame``, the capacity
  autotune
- :mod:`bibim_tpu_torch.host`      — the interactive Session (2-deep
  readback), the live viewer, the CLI (``python -m
  bibim_tpu_torch.host.app``), the GUI state, the in-frame HUD
- :mod:`bibim_tpu_torch.interop`   — numpy state of the JAX package → port
- :mod:`bibim_tpu_torch.utils`     — capacity validation, resource root,
  timing and profiling hooks
- :mod:`bibim_tpu_torch.native`    — ctypes binding of the native image
  runtime (``native/libbibim_native.so``)
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
