"""framegraph.host_ms: the median host ms of the ``render_frame`` call the
session makes (enqueueing the frame's kernels and torch ops)."""

import statistics


def read(run):
    xs = [s.ms for s in run.spans if s.name == "render_frame"]
    return statistics.median(xs) if xs else None
