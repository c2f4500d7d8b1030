"""readback.wait_ms: the median host ms inside the session's
``readback.submit`` (queueing the frame's copy and waiting for the
oldest frame in flight)."""

import statistics


def read(run):
    xs = [s.ms for s in run.spans if s.name == "readback.submit"]
    return statistics.median(xs) if xs else None
