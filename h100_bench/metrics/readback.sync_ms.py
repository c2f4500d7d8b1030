"""readback.sync_ms: the median ms of the program's ``readback.wait``
spans over the window frames: the host waiting on the oldest frame's copy
event, without the queueing that ``readback.wait_ms`` also holds."""

from h100_bench import program_trace


def read(run):
    return program_trace.span_median_ms(run, "readback.wait")
