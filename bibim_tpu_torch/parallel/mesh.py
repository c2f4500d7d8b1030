"""The band mesh of the sharded frame: which device renders each
horizontal band of the frame, and which process.

Two forms. :func:`make_device_mesh`: every band in this process, band
*k* on ``cuda:(k % device_count)`` (several bands share a card when there
are more bands than cards), or every band on the CPU.
:func:`make_process_mesh`: one band per rank of ``torch.distributed``,
from its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL
when each rank on a host has a card of its own, else gloo, whose
collectives run on host tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DeviceMesh:
    """Band *k* renders on ``devices[k]`` in the process of rank
    ``ranks[k]``; ``group`` is the process group that joins the ranks
    (None in one process), ``rank`` this process's rank, and
    ``collective_device`` where the collectives' tensors must live (the
    host for gloo)."""

    devices: tuple
    ranks: tuple
    group: object = None
    rank: int = 0
    collective_device: torch.device | None = None

    @property
    def n_bands(self) -> int:
        return len(self.devices)

    @property
    def local_bands(self) -> tuple:
        """The bands this process renders."""
        return tuple(k for k, r in enumerate(self.ranks) if r == self.rank)


def make_device_mesh(n_bands: int | None = None,
                     device="cuda") -> DeviceMesh:
    """Every band in this process: band *k* on ``cuda:(k % cards)`` (the
    default: one band a card), or all ``n_bands`` (default 1) on the CPU
    with ``device="cpu"``."""
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("make_device_mesh: no CUDA device")
        n = cards if n_bands is None else int(n_bands)
        devices = tuple(torch.device("cuda", k % cards) for k in range(n))
    else:
        n = 1 if n_bands is None else int(n_bands)
        devices = (torch.device(kind),) * n
    if n < 1:
        raise ValueError(f"make_device_mesh: {n} bands")
    return DeviceMesh(devices=devices, ranks=(0,) * n)


def make_process_mesh(device="cuda",
                      init_method: str = "env://") -> DeviceMesh:
    """One band per rank of ``torch.distributed``, from ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE`` where set,
    as ``torchrun`` sets it); joins the default process group at
    ``init_method`` unless it is already up. On the card a rank renders
    on ``cuda:(LOCAL_RANK % cards)`` and the ranks talk over NCCL when
    each rank on the host has a card of its own, else over gloo (several
    ranks on one card); ``device="cpu"`` takes gloo."""
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("make_process_mesh: no CUDA device")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= cards else "gloo"
    else:
        dev = torch.device(kind)
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    backend = dist.get_backend()
    names = [None] * world
    dist.all_gather_object(names, str(dev))
    return DeviceMesh(
        devices=tuple(torch.device(d) for d in names),
        ranks=tuple(range(world)), group=dist.group.WORLD, rank=rank,
        collective_device=dev if backend == "nccl" else torch.device("cpu"))
