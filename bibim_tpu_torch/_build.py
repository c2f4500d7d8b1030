"""Kernel loader: builds ``csrc/*.cu`` with ``nvcc`` into one shared library
with a plain C interface and loads it with ``ctypes``.

The build runs at first kernel launch (never at import), into ``build/`` at
the repository root, and is keyed by a hash of the sources and flags, so a
fresh checkout builds everything on its first call and a changed source
rebuilds. Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` — the raster's edge/depth plane
evaluations and the sampler's footprint math must not be contracted into
FMAs, or they stop being bit-equal to their plain PyTorch versions (which
round every product and sum separately).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("raster.cu", "overlay.cu", "shade.cu", "sort.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)
# Elements one block of the bitonic sort holds in shared memory
# (1024 threads × 2); must match SORT_BLOCK in csrc/sort.cu.
SORT_BLOCK_ELEMS = 2048
# Max (pixels per tile / threads per block) the raster and overlay kernels
# take; must match MAX_PPT in csrc/common.cuh.
MAX_TILE_PIXELS = 256 * 8


class Groups(ctypes.Structure):
    """Mirror of ``ShadeGroups`` in csrc/shade.cu (sampling groups of K2)."""

    MAX_GROUPS = 4
    _fields_ = [
        ("n", ctypes.c_int),
        ("kind", ctypes.c_int * 4),  # 0 block table, 1 quad table
        ("tab", ctypes.c_void_p * 4),
        ("row_bytes", ctypes.c_int * 4),
        ("h", ctypes.c_int * 4),
        ("w", ctypes.c_int * 4),
        ("cpad", ctypes.c_int * 4),
        ("n_present", ctypes.c_int * 4),
        ("slot", (ctypes.c_int * 10) * 4),
    ]


_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if the hashed build is missing; returns
    its path. ``verbose`` prints ptxas register/shared-memory usage."""
    global build_seconds
    out = BUILD_DIR / f"libbibim_kernels_{_digest()}.so"
    if out.is_file() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, starts,
        # counts, init_zkey, n_slots, tiles_x, tile_h, tile_w, rec_stride,
        # field mask, zkey out, fields out, stream
        "bb_raster": [p, p, p, i, p, i, p, p, p, p, i, i, i, i, i,
                      ctypes.c_uint, p, p, p],
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, starts,
        # counts, n_live, zkey, ldr in/out, n_slots, nt, tiles_x, tile_h,
        # tile_w, rec_stride, stream
        "bb_overlay": [p, p, p, i, p, i, p, p, p, p, p, p, i, i, i, i, i, i,
                       p],
        # groups, u, v, world×3, normal×3, tangent×3, valid, lights,
        # n_lights, view_pos, nm_enable, gbuffer_mode, quantize, n,
        # out r/g/b, stream
        "bb_shade": [ctypes.POINTER(Groups)] + [p] * 13
                    + [i, p, p, i, i, i, p, p, p, p],
        "bb_sort_i32": [p, i, p],
        "bb_sort_i64": [p, i, p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
