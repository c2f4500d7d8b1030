"""Double-buffered framebuffer readback (port of
``bibim_tpu.host.readback``).

The reference keeps 2 frames in flight (numFrames=2, main.cpp:38) with
fence/semaphore sync (FrameSync, render.h:348-352): the CPU records frame N
while the GPU finishes frame N−1. Here the frame's kernels are queued on
the current CUDA stream and the host returns at once; :meth:`submit`
queues the frame's copy to pinned host memory on a copy stream of its own
and hands back the oldest frame in flight, waiting only on that frame's
copy event, so the host never blocks on the frame it just submitted.
"""

from __future__ import annotations

import torch


class DoubleBufferedReadback:
    """Submit device frames; get host copies ``depth - 1`` frames behind.

    A frame is a tensor or a tuple of tensors (the image and small
    per-frame values that must reach the host with it, such as capacity
    diagnostics); it comes back as a numpy array or a tuple of them.

    On a CUDA device each tensor is copied with ``non_blocking=True`` into
    a pinned host buffer, on a copy stream that first waits for the
    current stream, and a CUDA event marks the frame's copies done; the
    device tensor is ``record_stream``-ed to the copy stream so that its
    memory is not reused before the copy has read it. The pinned buffers
    come from PyTorch's caching host allocator, a pool per size: the
    array handed back owns its buffer, which returns to the pool when the
    array is dropped. On the CPU a frame is copied at submit
    (``.numpy().copy()``).
    """

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"readback depth must be >= 1, got {depth}")
        self._depth = depth
        self._inflight: list = []
        self._streams: dict = {}  # CUDA device → its copy stream

    @property
    def depth(self) -> int:
        return self._depth

    def _queue(self, tensors: tuple):
        dev = tensors[0].device
        if dev.type != "cuda":
            return tuple(t.detach().numpy().copy() for t in tensors), None
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        hosts = []
        with torch.cuda.stream(stream):
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
                hosts.append(h)
            done = torch.cuda.Event()
            done.record(stream)
        return tuple(hosts), done

    @staticmethod
    def _ready(entry):
        hosts, done, single = entry
        if done is not None:
            done.synchronize()
            hosts = tuple(h.numpy() for h in hosts)
        return hosts[0] if single else hosts

    def submit(self, frame):
        """Queue a (dispatched, not awaited) device frame. Returns the host
        copy of the oldest in-flight frame once ``depth`` frames are in
        flight, else None; blocks only on that frame's copy."""
        single = isinstance(frame, torch.Tensor)
        tensors = (frame,) if single else tuple(frame)
        hosts, done = self._queue(tensors)
        self._inflight.append((hosts, done, single))
        if len(self._inflight) >= self._depth:
            return self._ready(self._inflight.pop(0))
        return None

    def flush(self) -> list:
        """Drain all in-flight frames, oldest first (vkDeviceWaitIdle
        analog at shutdown)."""
        out = [self._ready(e) for e in self._inflight]
        self._inflight.clear()
        return out
