"""autotune.ms_per_s: host ms in the program's ``session.retune`` spans
over the window frames (the profiled segment left out), per second of
those frames' calls; 0 where no frame retuned."""

from h100_bench import program_trace


def read(run):
    return program_trace.retune_ms_per_s(run)
