"""Image decode (a copy of the JAX package's ``assets/image.py`` PIL
path): any PNG/JPG to (H, W, 4) uint8 as stbi_load(..., STBI_rgb_alpha)
gives it. Mip chains are ``ops.texture_quad.build_mip_pyramid``."""

from __future__ import annotations

import os

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
