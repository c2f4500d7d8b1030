"""ctypes binding for the native C++ image runtime (the port's copy of
``bibim_tpu.native``): ``native/libbibim_native.so``, built by
``make -C native``, decodes PNG / JPEG, writes PNG with libpng and
encodes JPEG with libjpeg.

The library is loaded on first use, not on import. Where it is missing
or will not load (built for another machine, libpng / libjpeg absent),
each function returns None (``write_png``: False) and its caller falls
back to PIL.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

_LIB_PATH = (Path(__file__).resolve().parents[1] / "native"
             / "libbibim_native.so")


class _DecodedImage(ctypes.Structure):
    _fields_ = [
        ("pixels", ctypes.POINTER(ctypes.c_uint8)),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
    ]


@functools.cache
def _lib():
    """The loaded library with its signatures declared, or None."""
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bibim_decode_image.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(_DecodedImage)]
    lib.bibim_decode_image.restype = ctypes.c_int
    lib.bibim_free_image.argtypes = [ctypes.POINTER(_DecodedImage)]
    lib.bibim_free_image.restype = None
    lib.bibim_native_version.argtypes = []
    lib.bibim_native_version.restype = ctypes.c_char_p
    if hasattr(lib, "bibim_write_png"):
        lib.bibim_write_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
        lib.bibim_write_png.restype = ctypes.c_int
    if hasattr(lib, "bibim_encode_jpeg"):
        lib.bibim_encode_jpeg.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(u8p)]
        lib.bibim_encode_jpeg.restype = ctypes.c_int
        lib.bibim_free_buffer.argtypes = [u8p]
        lib.bibim_free_buffer.restype = None
    return lib


def native_version() -> str | None:
    lib = _lib()
    return None if lib is None else lib.bibim_native_version().decode()


def _rgb_or_rgba(image: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(image)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"need (H, W, 3|4) uint8, got {arr.shape} "
                         f"{arr.dtype}")
    return arr


def decode_image_rgba8(path: str) -> np.ndarray | None:
    """Decode one PNG/JPEG to (H, W, 4) uint8; None on failure or
    without the library."""
    lib = _lib()
    if lib is None:
        return None
    img = _DecodedImage()
    if not lib.bibim_decode_image(str(path).encode(), ctypes.byref(img)):
        return None
    n = img.width * img.height * 4
    buf = np.ctypeslib.as_array(img.pixels, shape=(n,))
    out = buf.reshape(img.height, img.width, 4).copy()
    lib.bibim_free_image(ctypes.byref(img))
    return out


def write_png(path: str, image: np.ndarray, compress_level: int = 1) -> bool:
    """Write an (H, W, 3|4) uint8 array as PNG with the native writer
    (libpng at a low compression level). False without the library or
    its writer, or on an IO failure."""
    lib = _lib()
    arr = _rgb_or_rgba(image)
    if lib is None or not hasattr(lib, "bibim_write_png"):
        return False
    h, w, c = arr.shape
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return bool(lib.bibim_write_png(str(path).encode(), ptr, w, h, c,
                                    compress_level))


def encode_jpeg(image: np.ndarray, quality: int = 85) -> bytes | None:
    """Encode an (H, W, 3|4) uint8 array to JPEG bytes with the native
    encoder (the live viewer's present path). None without the library
    or its encoder, or on an encode failure."""
    lib = _lib()
    arr = _rgb_or_rgba(image)
    if lib is None or not hasattr(lib, "bibim_encode_jpeg"):
        return None
    h, w, c = arr.shape
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.bibim_encode_jpeg(ptr, w, h, c, quality, ctypes.byref(out))
    if n <= 0:
        return None
    data = ctypes.string_at(out, n)
    lib.bibim_free_buffer(out)
    return data
