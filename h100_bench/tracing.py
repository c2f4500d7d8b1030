"""Spans and the device trace of a ``--trace 1`` run.

Spans come from the benchmark's own wrappers around the calls into each
layer of the program (``Session.render``, the ``render_frame`` name the
session module calls, ``pipeline.autotune.autotune_settings``, the
session's ``readback.submit``), on the host clock; inside a profiled
segment each span is also a ``torch.profiler.record_function`` range, so
that the device's idle gaps can be labelled with the span the host was
in. Device times come from ``torch.profiler`` over that segment.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from dataclasses import dataclass, field

# The program's hand-written kernels (bibim_tpu_torch/csrc), by the
# function name the profiler shows after ``bb::``.
PORT_KERNELS = {
    "raster_kernel": "K1", "shade_kernel": "K2", "sort_cluster": "K3",
    "sort_onesweep": "K3", "overlay_kernel": "K4",
    "gbuffer_shade_kernel": "K5", "sample_block_kernel": "K6",
    "sample_block_pair_kernel": "K6", "sample_small_kernel": "K7",
    "mip_block_kernel": "K8", "raster_earlyz_kernel": "K9",
    "raster_gw_kernel": "K10", "raster_fine_kernel": "K11",
}
_BB = re.compile(r"bb::(\w+)")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelEx")


def port_kernel(name: str) -> str | None:
    """The K-number of a device op's name, if it is one of the port's
    kernels (other bb:: functions, such as K3's helpers, count as
    K3's when their name says so)."""
    m = _BB.search(name)
    if not m:
        return None
    fn = m.group(1)
    if fn in PORT_KERNELS:
        return PORT_KERNELS[fn]
    return "K3" if fn.startswith("sort_") else None


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    depth: int
    frame: int

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclass
class Spans:
    """Records nested spans; ``profiling`` adds a record_function range
    to each."""

    spans: list = field(default_factory=list)
    frame: int = -1
    profiling: bool = False
    _depth: int = 0

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profiling:
            import torch

            ctx = torch.profiler.record_function(name)
        depth = self._depth
        self._depth += 1
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.spans.append(Span(name, t0, time.perf_counter(), depth,
                                   self.frame))
            self._depth -= 1

    def wrap(self, name: str, fn):
        def wrapped(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)

        return wrapped


def self_ms(spans: list, name: str) -> list:
    """Each ``name`` span's host ms less its direct children's."""
    by_frame: dict = {}
    for s in spans:
        by_frame.setdefault(s.frame, []).append(s)
    out = []
    for group in by_frame.values():
        for s in group:
            if s.name != name:
                continue
            kids = sum(c.t1 - c.t0 for c in group
                       if c.depth == s.depth + 1 and c.t0 >= s.t0
                       and c.t1 <= s.t1)
            out.append((s.t1 - s.t0 - kids) * 1e3)
    return out


@dataclass
class DeviceTrace:
    """What the profiled segment read: device ops (name, start us, end
    us), host spans (name, start us, end us, depth) on the profiler's
    clock, kernel launch calls, frames and wall seconds."""

    ops: list
    spans: list
    launches: int
    frames: int
    window_s: float

    def busy_intervals(self) -> list:
        """Union of the device ops' intervals (us), in order."""
        out = []
        for a, b in sorted((o[1], o[2]) for o in self.ops):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self) -> list:
        """Idle gaps between device work: (start us, end us, the
        innermost benchmark span the host was in at the gap's middle, or
        "outside spans")."""
        iv = self.busy_intervals()
        gaps = [(a, b) for (_, a), (b, _) in zip(iv, iv[1:])]
        mids = [0.5 * (a + b) for a, b in gaps]
        label = ["outside spans"] * len(gaps)
        depth = [-1] * len(gaps)
        for name, a, b, d in self.spans:
            for k in range(bisect.bisect_left(mids, a),
                           bisect.bisect_right(mids, b)):
                if d > depth[k]:
                    label[k], depth[k] = name, d
        return [(a, b, lab) for (a, b), lab in zip(gaps, label)]

    def breakdown(self) -> dict:
        """The ten device ops that took the most time, and idle time by
        the span the host was in (the ten largest), in seconds."""
        by_op: dict = {}
        for name, a, b in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        by_gap: dict = {}
        for a, b, label in self.gaps():
            by_gap[label] = by_gap.get(label, 0.0) + (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def device_busy_s(prof) -> float:
    """Seconds in which an operation (kernel, copy, set) ran on the device
    over a finished ``torch.profiler.profile`` of CUDA activity: the union
    of the device ops' intervals. Read from the profiler's raw events, so
    that a window's millions of launches cost seconds, not minutes."""
    import gc

    import numpy as np
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    # Millions of short-lived objects: the collector would walk them all
    # again and again.
    was = gc.isenabled()
    gc.disable()
    try:
        iv = [(e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.is_user_annotation()]
        if not iv:
            return 0.0
        a = np.asarray(iv, np.int64)
        del iv
    finally:
        if was:
            gc.enable()
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    # An interval opens a new busy stretch where it starts after every
    # earlier one has ended.
    opens = np.ones(len(a), bool)
    opens[1:] = a[1:, 0] > reach[:-1]
    first = np.flatnonzero(opens)
    last = np.append(first[1:] - 1, len(a) - 1)
    return float((reach[last] - a[first, 0]).sum()) / 1e9


def read_profile(prof, span_names, frames: int,
                 window_s: float) -> DeviceTrace:
    """A :class:`DeviceTrace` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, spans, launches = [], [], 0
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # A span's range on the device's timeline is no device op.
            if e.name not in span_names:
                ops.append((e.name, t0, t1))
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif e.name in span_names:
            spans.append((e.name, t0, t1, 0))
    # Depth by nesting: a span inside another is deeper.
    spans.sort(key=lambda s: (s[1], -s[2]))
    nested, stack = [], []
    for name, a, b, _ in spans:
        while stack and stack[-1] <= a:
            stack.pop()
        nested.append((name, a, b, len(stack)))
        stack.append(b)
    return DeviceTrace(ops=ops, spans=nested, launches=launches,
                       frames=frames, window_s=window_s)
