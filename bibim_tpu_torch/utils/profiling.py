"""Tracing / profiling hooks (port of ``bibim_tpu.utils.profiling``).

- :func:`stage_scope` names a pipeline stage in ``torch.profiler`` traces
  (and, on a CUDA device, in an NVTX range)
- :func:`device_trace` records a ``torch.profiler`` trace of the host and
  the card and writes it as a Chrome trace
- :class:`FrameStats`: the rolling FPS / ms counter of the host loop
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def stage_scope(name: str, device=None):
    """Name a pipeline stage in device traces (the reference's debug
    labels, render.cpp labelGPUResource): a ``record_function`` range,
    and an NVTX range when ``device`` is a CUDA device."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block (CPU activity, and the card's where CUDA is
    available) and write ``<log_dir>/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclass
class FrameStats:
    """Rolling frame-time statistics for the host loop."""

    window: int = 60
    _times: list = field(default_factory=list)
    _last: float | None = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        if dt > 0:
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        return dt

    @property
    def ms_per_frame(self) -> float:
        if not self._times:
            return 0.0
        return 1e3 * sum(self._times) / len(self._times)

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1e3 / ms if ms > 0 else 0.0

    def summary(self) -> str:
        return f"{self.ms_per_frame:.2f} ms/frame ({self.fps:.1f} fps)"
