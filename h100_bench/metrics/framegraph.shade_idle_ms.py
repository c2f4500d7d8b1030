"""framegraph.shade_idle_ms: device-idle ms a profiled frame whose idle
gap's middle lies in the program's ``frame.shade`` span (live-tile
compaction, shadows and shading), the program's clock mapped onto the
profiler's (``program_trace.stage_idle_ms``)."""

from h100_bench import program_trace


def read(run):
    return program_trace.stage_idle_ms(run, "frame.shade")
