"""Image decode and PNG output (a copy of the JAX package's
``assets/image.py`` host paths): any PNG/JPG to (H, W, 4) uint8 as
stbi_load(..., STBI_rgb_alpha) gives it, and :func:`save_png`. Mip chains
are ``ops.texture_quad.build_mip_pyramid``."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image


def load_image_rgba8(path: str | os.PathLike) -> np.ndarray:
    """Decode to (H, W, 4) uint8; 16-bit grayscale narrows as stb_image
    does (value >> 8)."""
    im = Image.open(path)
    if im.mode in ("I;16", "I;16B", "I"):
        arr16 = np.asarray(im, dtype=np.uint32)
        gray = (arr16 >> 8).astype(np.uint8)
        rgba = np.dstack([gray, gray, gray, np.full_like(gray, 255)])
        return np.ascontiguousarray(rgba)
    if im.mode != "RGBA":
        im = im.convert("RGBA")
    return np.asarray(im, dtype=np.uint8).copy()


def save_png(path: str | os.PathLike, rgba_or_rgb: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 array (or [0, 1] floats) as PNG: the
    native libpng writer at a low compression level where
    ``native/libbibim_native.so`` loads, PIL otherwise."""
    from bibim_tpu_torch import native

    arr = np.asarray(rgba_or_rgb)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if arr.ndim == 3 and arr.shape[2] in (3, 4) and native.write_png(
            str(path), arr):
        return
    Image.fromarray(arr).save(path)
