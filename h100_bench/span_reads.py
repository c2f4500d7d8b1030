"""Readings of the program's spans and counters below its five stages,
and of the device time of the kernels launched inside a span, after a
window (the records and the clock mapping of :mod:`program_trace`).

Each returns None where the program recorded nothing it reads: no
recorder, no such span or counter in the window, or, for device time, no
profiled segment, no launches kept by the driver (``Window.launches``) or
clocks that do not map.
"""

from __future__ import annotations

import bisect
import statistics

from h100_bench import program_trace, tracing


def span_ms(run, name: str) -> float | None:
    """The median, over the window frames that ran ``name``, of a frame's
    ms in its ``name`` spans."""
    t = program_trace.load(run)
    if t is None:
        return None
    per: dict = {}
    for r in t.in_frames(name):
        per[r.frame] = per.get(r.frame, 0) + r.end_ns - r.start_ns
    return statistics.median(per.values()) / 1e6 if per else None


def count_per_frame(run, name: str) -> float | None:
    """The mean, over the window frames that ran ``framegraph.frame``, of
    counter ``name`` under it; None where no window frame counted it."""
    t = program_trace.load(run)
    if t is None:
        return None
    roots = {r.seq: 0 for r in t.in_frames("framegraph.frame")}
    seen = False
    for r in t.records:
        if r.count is not None and r.name == name:
            root = program_trace._ancestor(r, roots, t.by_seq)
            if root is not None:
                roots[root] += r.count
                seen = True
    return sum(roots.values()) / len(roots) if seen else None


def kernel_s_in_span(run, kernel: str, span: str) -> float | None:
    """Device seconds, over the profiled segment, of the launches of port
    kernel ``kernel`` (``"K1"``..) whose launch call started inside a
    ``span`` span of a profiled call, the program's clock mapped onto the
    profiler's by :func:`program_trace.clock_offset_us`."""
    launches = getattr(run.window, "launches", None)
    t = program_trace.load(run)
    if not launches or t is None:
        return None
    off = program_trace.clock_offset_us(run)
    if off is None:
        return None
    calls = [(c.t0, c.t1) for c in run.window.calls
             if c.dispatched in run.window.profiled]
    inside = sorted((r.start_ns / 1e3 + off, r.end_ns / 1e3 + off)
                    for r in t.records
                    if r.count is None and r.name == span
                    and any(a <= r.start_ns / 1e9 <= b for a, b in calls))
    if not inside:
        return None
    starts = [lo for lo, _ in inside]

    def in_span(at):
        k = bisect.bisect_right(starts, at) - 1
        return k >= 0 and at <= inside[k][1]

    us = sum(b - a for at, name, a, b, _ in launches
             if tracing.port_kernel(name) == kernel and in_span(at))
    return us / 1e6
