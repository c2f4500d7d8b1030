"""Pair sort for binning — kernel K3 (port of ``bibim_tpu.ops.sort_pallas``).

``bin_pairs`` packs each (tile, triangle) pair into one key and sorts the
keys ascending; live pairs are unique, so any correct sort gives the same
order, which is the (tile, triangle) lexicographic order.

:func:`sort_keys` is the kernel wrapper: CUDA tensors go to the bitonic
sort in ``csrc/sort.cu`` (every size, int32 or int64 keys), CPU tensors to
the plain version :func:`sort_keys_plain` (``torch.sort``).
"""

from __future__ import annotations

import ctypes

import torch

from bibim_tpu_torch import _build


def pack_bits(nt: int, t: int) -> int | None:
    """Bits for the triangle field of a non-negative int32 key packing
    (tile ∈ [0, nt], tri ∈ [0, t)), or None when it does not fit (the
    caller then sorts int64 keys)."""
    tile_bits = int(nt).bit_length()
    tri_bits = max(int(t - 1).bit_length(), 1)
    if tile_bits + tri_bits > 31:
        return None
    return tri_bits


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ascending sort of int32/int64 keys."""
    return torch.sort(keys).values


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a (P,) int32 or int64 key tensor (K3)."""
    if keys.ndim != 1 or keys.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"sort_keys takes (P,) int32/int64 keys, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if keys.device.type == "cpu":
        return sort_keys_plain(keys)
    if keys.device.type != "cuda":
        raise RuntimeError(f"sort_keys: unsupported device {keys.device}")
    p = keys.shape[0]
    if p <= 1:
        return keys.clone()
    n = max(_build.SORT_BLOCK_ELEMS, 1 << (p - 1).bit_length())
    pad = torch.iinfo(keys.dtype).max
    buf = torch.full((n,), pad, dtype=keys.dtype, device=keys.device)
    buf[:p] = keys
    lib = _build.library()
    fn = lib.bb_sort_i32 if keys.dtype == torch.int32 else lib.bb_sort_i64
    err = fn(ctypes.c_void_p(buf.data_ptr()), ctypes.c_int(n),
             _build.stream_ptr(keys.device))
    _build.check(err, "sort")
    sort_keys.launches += 1
    return buf[:p]


sort_keys.launches = 0


def sort_pairs(flat_tile: torch.Tensor, tri_of_pair: torch.Tensor, nt: int,
               t_count: int, sort=sort_keys):
    """Sort (tile, tri) pairs ascending by tile then triangle.

    Returns (sorted_tile, sorted_tri), both int32."""
    tri_bits = pack_bits(nt, t_count)
    if tri_bits is None:
        key = (flat_tile.to(torch.int64) << 32) | tri_of_pair.to(torch.int64)
        s = sort(key)
        return (s >> 32).to(torch.int32), (s & 0xFFFFFFFF).to(torch.int32)
    key = (flat_tile << tri_bits) | tri_of_pair
    s = sort(key)
    return s >> tri_bits, s & ((1 << tri_bits) - 1)
