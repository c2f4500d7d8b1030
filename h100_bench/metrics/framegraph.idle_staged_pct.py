"""framegraph.idle_staged_pct: of the profiled segment's device-idle time
whose gap's middle lies in the program's ``framegraph.frame`` span, the
share (%) whose middle lies in one of its five stage spans
(``program_trace.idle_staged_pct``; the program's clock mapped onto the
profiler's by ``program_trace.clock_offset_us``)."""

from h100_bench import program_trace


def read(run):
    return program_trace.idle_staged_pct(run)
