"""Pair sort for binning — kernel K3 (port of ``bibim_tpu.ops.sort_pallas``).

``bin_pairs`` packs each (tile, triangle) pair into one key and sorts the
keys ascending; live pairs are unique, so any correct sort gives the same
order, which is the (tile, triangle) lexicographic order. The early-z
order (:func:`sort_pairs_z`) packs (tile, inverted depth bucket, triangle)
the same way.

:func:`sort_keys` is the kernel wrapper: CUDA tensors go to the LSD radix
sort in ``csrc/sort.cu`` (8-bit digits of the keys' order-preserving
unsigned form, every size, int32 or int64 keys; up to 96 k keys in the
shared memory of one thread-block cluster, one launch; else a memset, then
histograms and one stable one-sweep scatter per digit in one cooperative
launch), CPU tensors to the plain version :func:`sort_keys_plain`
(``torch.sort``).
:func:`digit_plan` says which digits a set of keys makes the kernel
scatter by: it skips, on the device, every digit that is the same for all
keys.
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


def radix_digits(keys: torch.Tensor) -> torch.Tensor:
    """(D, P) int64: the 8-bit digits of each key's order-preserving
    unsigned form (its sign bit flipped), least significant first — the
    digits K3's passes scatter by (D = 4 for int32, 8 for int64)."""
    k = keys.to(torch.int64)
    d = torch.stack([(k >> (8 * i)) & 0xFF
                     for i in range(keys.element_size())])
    d[-1] ^= 0x80
    return d


def digit_plan(keys: torch.Tensor) -> tuple:
    """The digits an LSD radix sort of ``keys`` must run, least significant
    first: those on which some keys differ. A stable pass on a digit that
    every key shares is the identity, so K3 skips it (it decides that on
    the device, from its histograms)."""
    if keys.numel() == 0:
        return ()
    d = radix_digits(keys)
    return tuple(i for i in range(d.shape[0])
                 if bool((d[i] != d[i, :1]).any()))


def sort_keys(keys: torch.Tensor, route: int | None = None) -> torch.Tensor:
    """Ascending sort of a (P,) int32 or int64 key tensor (K3). On the card
    it makes 1 device launch on the one-cluster route, else 2 (a memset of
    its scratch and one cooperative kernel); both counts go to
    ``sort_keys.device_launches``. ``route`` overrides the kernel's pick
    (0: many blocks, c: one cluster of c blocks; a measurement knob, any
    route gives the same result)."""
    if keys.ndim != 1 or keys.dtype not in _KEY_FNS:
        raise ValueError(f"sort_keys takes (P,) int32/int64 keys, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    dev = keys.device
    if dev.type == "cpu":
        return sort_keys_plain(keys)
    if dev.type != "cuda":
        raise RuntimeError(f"sort_keys: unsupported device {dev}")
    p = keys.shape[0]
    if p >= 1 << 30:
        raise ValueError(f"sort_keys: {p} keys exceed 2^30")
    if p <= 1:
        return keys.clone()
    if not keys.is_contiguous():
        keys = keys.contiguous()
    lib = _build.library()
    size = keys.element_size()
    route = -1 if route is None else route
    nbytes = lib.bb_sort_work_bytes(p, size, route)
    if nbytes < 0:
        raise RuntimeError(f"sort_keys: route {route} cannot sort {p} keys "
                           "on this device")
    out = torch.empty_like(keys)
    tmp = 0
    if nbytes:  # the many-block route's second key buffer and scratch
        work = torch.empty((nbytes // 4,), dtype=torch.int32, device=dev)
        tmp = work.data_ptr()
    launches = ctypes.c_int(0)
    err = getattr(lib, _KEY_FNS[keys.dtype])(
        keys.data_ptr(), out.data_ptr(), tmp, p, tmp + p * size if tmp else 0,
        route, ctypes.byref(launches), _build.stream_ptr(dev))
    _build.check(err, "sort")
    sort_keys.launches += 1
    sort_keys.device_launches += launches.value
    return out


_KEY_FNS = {torch.int32: "bb_sort_i32", torch.int64: "bb_sort_i64"}
sort_keys.launches = 0
sort_keys.device_launches = 0


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


def zorder_bits(nt: int, t: int, max_bits: int = 16) -> int:
    """Depth-bucket bits that fit an int32 (tile | inv_bucket | tri) key;
    0 = none fit (:func:`sort_pairs_z` then sorts int64 keys with a
    ``max_bits`` bucket)."""
    tile_bits = int(nt).bit_length()
    tri_bits = max(int(t - 1).bit_length(), 1)
    return max(0, min(max_bits, 31 - tile_bits - tri_bits))


def zbucket(zub: torch.Tensor, bits: int) -> torch.Tensor:
    """Monotone depth bucket of a [0, 1] float32 depth bound: the float's
    bit pattern >> (30 − bits), an exponent ladder with 2^(bits−8) steps
    per octave. The early-z raster (K9) rebuilds a bucket's upper bound
    with the same shift."""
    zb = torch.maximum(zub, torch.zeros_like(zub)).view(torch.int32)
    return zb >> (30 - bits)


def sort_pairs_z(flat_tile: torch.Tensor, zub_of_pair: torch.Tensor,
                 tri_of_pair: torch.Tensor, nt: int, t_count: int,
                 bits: int, sort=sort_keys):
    """Early-z pair order: ascending (tile, DESCENDING depth bucket, tri)
    — near candidates first within a tile, draw order within a bucket.

    ``bits`` > 0: one int32 key (tile | inverted ``bits``-bit bucket |
    tri), as the reference packs it. ``bits`` == 0: the reference's
    3-operand sort with a 16-bit bucket, here one int64 key (tile <<
    49 | (inv + 2^16) << 32 | tri) — the same order, since the triples
    are unique. Returns (sorted_tile, sorted_tri), both int32."""
    if bits <= 0:
        if int(nt).bit_length() > 14:
            raise ValueError(f"sort_pairs_z: {nt} tiles exceed the int64 key")
        inv = (1 << 16) - 1 - zbucket(zub_of_pair, 16)
        key = ((flat_tile.to(torch.int64) << 49)
               | ((inv.to(torch.int64) + (1 << 16)) << 32)
               | tri_of_pair.to(torch.int64))
        s = sort(key.contiguous())
        return (s >> 49).to(torch.int32), (s & 0xFFFFFFFF).to(torch.int32)
    tri_bits = max(int(t_count - 1).bit_length(), 1)
    inv = (1 << bits) - 1 - zbucket(zub_of_pair, bits)
    packed = (((flat_tile << bits) | inv) << tri_bits) | tri_of_pair
    s = sort(packed.contiguous())
    return s >> (bits + tri_bits), s & ((1 << tri_bits) - 1)
