"""readback.queue_ms: the median ms of the program's ``readback.queue``
spans over the window frames: the host queueing a frame's copies to
pinned memory on the copy stream, without the wait that
``readback.sync_ms`` reads."""

from h100_bench import program_trace


def read(run):
    return program_trace.span_median_ms(run, "readback.queue")
