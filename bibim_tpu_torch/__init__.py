"""bibim_tpu_torch — the PyTorch + CUDA port of the bibim_tpu renderer.

The JAX package ``bibim_tpu`` is the reference; this package mirrors its
layout module for module and runs the deferred PBR frame on an NVIDIA
Hopper card. Plain tensor code is PyTorch; the four kernels of the frame's
hot path are hand-written CUDA C++ (``csrc/``), built with ``nvcc`` into
one shared library at first use (see ``_build.py``):

- K1 raster + resolve        → ``ops.fused.raster_tiles``   (csrc/raster.cu)
- K2 sampled shade           → ``ops.shading.shade_sampled`` (csrc/shade.cu)
- K3 pair sort               → ``ops.sort.sort_keys``       (csrc/sort.cu)
- K4 overlay composite       → ``ops.fused.overlay_tiles``  (csrc/overlay.cu)

Every kernel wrapper takes its plain PyTorch version for CPU tensors only;
a CUDA tensor reaches the kernel or the wrapper raises. Importing this
package needs neither ``nvcc`` nor a GPU, and never imports ``jax``.

Layout:

- :mod:`bibim_tpu_torch.math3d`    — matrix conventions (reversed-Z)
- :mod:`bibim_tpu_torch.scene`     — draw batches, lights, camera, scenes
- :mod:`bibim_tpu_torch.ops`       — geometry, setup, binning, kernels,
  texture tables, shading, tone mapping
- :mod:`bibim_tpu_torch.pipeline`  — ``render_frame``
- :mod:`bibim_tpu_torch.interop`   — numpy state of the JAX package → port
- :mod:`bibim_tpu_torch.utils`     — capacity validation
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
