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
SOURCES = ("raster.cu", "shade.cu", "sort.cu",
           "gbuffer_shade.cu", "sample.cu", "mip_sample.cu",
           "raster_earlyz.cu", "raster_fine.cu")
HEADERS = ("common.cuh", "shading.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)
# Max (pixels per tile / threads per block) the raster and overlay kernels
# take; must match MAX_PPT in csrc/common.cuh.
MAX_TILE_PIXELS = 256 * 8


class Groups(ctypes.Structure):
    """Mirror of ``ShadeGroups`` in csrc/shading.cuh (sampling groups of
    K2)."""

    MAX_GROUPS = 4
    # kind: BLOCK/QUAD sample at (u, v); MIP_BLOCK and ROUTED_QUAD read
    # per-pixel planes gi (int32) / gf (float32).
    BLOCK, QUAD, MIP_BLOCK, ROUTED_QUAD = range(4)
    _fields_ = [
        ("n", ctypes.c_int),
        ("kind", ctypes.c_int * 4),
        ("tab", ctypes.c_void_p * 4),
        ("rows", ctypes.c_int * 4),
        ("row_bytes", ctypes.c_int * 4),
        ("h", ctypes.c_int * 4),
        ("w", ctypes.c_int * 4),
        ("cpad", ctypes.c_int * 4),
        ("n_present", ctypes.c_int * 4),
        ("slot", (ctypes.c_int * 10) * 4),
        ("gi", ctypes.c_void_p * 4),
        ("gf", ctypes.c_void_p * 4),
    ]


_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = ""  # nvcc's output of the last verbose build (ptxas usage)


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


def _run(procs: list) -> str:
    """Wait for every (name, Popen); raise on the first failure."""
    logs = []
    for name, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                if other.poll() is None:
                    other.kill()
                    other.communicate()
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):"
                               f"\n{stdout}\n{stderr}")
        logs.append(stdout + stderr)
    return "".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if the hashed build is missing; returns
    its path. One nvcc per source, all started together, then one link.
    ``verbose`` prints ptxas register/shared-memory usage and keeps it in
    :data:`build_log`."""
    global build_seconds, build_log
    digest = _digest()
    out = BUILD_DIR / f"libbibim_kernels_{digest}.so"
    if out.is_file() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    objs, procs = [], []
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for s in SOURCES:
            obj = BUILD_DIR / f"{Path(s).stem}.{tag}.o"
            cmd = [nvcc, *compile_flags, "-I", str(CSRC), "-c"]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(obj), str(CSRC / s)]
            procs.append((s, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        log = _run(procs)
        log += _run([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
    finally:
        # A failed compile or link leaves no partial objects behind.
        for f in objs:
            f.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        build_log = log
        print(log)
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, starts,
        # counts, init_zkey, n_slots, tiles_x, tile_h, tile_w, rec_stride,
        # field mask, cluster size, zkey out, fields out, stream
        "bb_raster": [p, p, p, i, p, i, p, p, p, p, i, i, i, i, i,
                      ctypes.c_uint, i, p, p, p],
        # rec, pair_tri, pair_len, ids, starts, counts, part ends, n_slots,
        # row_off, tiles_x, tile_h, tile_w, rec_stride, field mask, packed
        # maxima, arrival counters, part counter, zkey (in place), fields
        # (in place), field plane stride, stream
        "bb_raster_tail": [p, p, i, p, p, p, p, i, i, i, i, i, i,
                           ctypes.c_uint, p, p, p, p, p, ctypes.c_longlong,
                           p],
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, starts,
        # counts, init_zkey, init_okey, n_slots, tiles_x, tile_h, tile_w,
        # rec_stride, field mask, zsh, cluster size, zkey out, okey out,
        # fields out, stats (or NULL), stream
        "bb_raster_earlyz": [p, p, p, i, p, i, p, p, p, p, p, i, i, i, i, i,
                             ctypes.c_uint, i, i, p, p, p, p, p],
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, win,
        # lb_al, cnt_k, init_zkey, n_slots, group, tiles_x, tile_h, tile_w,
        # rec_stride, field mask, cluster size, zkey out, fields out, stream
        "bb_raster_gw": [p, p, p, i, p, i, p, p, p, p, p, i, i, i, i, i, i,
                         ctypes.c_uint, i, p, p, p],
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, starts,
        # lb_al, cntk, init_zkey, n_slots, nsub, tiles_x, tile_h, tile_w,
        # rec_stride, field mask, parts, zkey out, fields out, stream
        "bb_raster_fine": [p, p, p, i, p, i, p, p, p, p, p, i, i, i, i, i, i,
                           ctypes.c_uint, i, p, p, p],
        # rec, big_ids, n_big, big_len, pair_tri, pair_len, ids, starts,
        # counts, n_live, zkey (or NULL), ldr in/out, ldr channel stride,
        # n_slots, tiles_x, tile_h, tile_w, rec_stride, cluster size,
        # clusters, stream
        "bb_overlay": [p, p, p, i, p, i, p, p, p, p, p, p, ctypes.c_longlong,
                       i, i, i, i, i, i, i, p],
        # groups, u, v, world×3, normal×3, tangent×3, valid, vis (or
        # NULL), lights, n_lights, view_pos, nm_enable, quantize, exposure
        # and tonemap enable (or NULL), quantize_hdr, tonemap, generic,
        # pair level, tile width, n, out r/g/b, stream
        "bb_shade": [ctypes.POINTER(Groups)] + [p] * 14
                    + [i, p, p, i, p, p, i, i, i, i, i, i, p, p, p, p],
        # world×3, normal×3, albedo×3, metallic, roughness, ao, valid,
        # vis (or NULL), ambient×3 (or NULL), lights, n_lights, view_pos,
        # exposure, tonemap enable, quantize, tonemap, n, out r/g/b, stream
        "bb_shade_gbuffer": [p] * 18 + [i, p, p, p, i, i, i, p, p, p, p],
        # blocks, row_bytes, h, w, cpad, n_out, u, v, valid (or NULL),
        # pair level, tile width, n, slot plane stride, out, stream
        "bb_sample_block": [p, i, i, i, i, i, p, p, p, i, i, i, i, p, p],
        # quads, rows, cpad, n_out, idx, tx, ty, n, out, stream
        "bb_sample_small": [p, i, i, i, p, p, p, i, p, p],
        # blocks, row_bytes, cs, level table, materials, levels a
        # material, u, v, material ids (or NULL), tiles, tile_h, tile_w,
        # out, stream
        "bb_sample_mip_block": [p, i, i, p, i, i, p, p, p, i, i, i, p, p],
        # keys in, keys out, second key buffer, n, scratch, route (-1:
        # its pick, 0: many blocks, c: one cluster of c blocks), device
        # launches made (int out), stream
        "bb_sort_i32": [p, p, p, i, p, i, p, p],
        "bb_sort_i64": [p, p, p, i, p, i, p, p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    # n, key bytes, route -> workspace bytes of the sort (0: one cluster
    # holds the keys, -1: no device or a route that cannot sort n keys);
    # n, key bytes -> the cluster size it picks (0: many blocks)
    lib.bb_sort_work_bytes.argtypes = [i, i, i]
    lib.bb_sort_work_bytes.restype = ctypes.c_longlong
    lib.bb_sort_cluster.argtypes = [i, i]
    lib.bb_sort_cluster.restype = ctypes.c_int
    # groups -> the K2 instantiation bb_shade runs (0: the generic one)
    lib.bb_shade_layout.argtypes = [ctypes.POINTER(Groups)]
    lib.bb_shade_layout.restype = ctypes.c_int


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
