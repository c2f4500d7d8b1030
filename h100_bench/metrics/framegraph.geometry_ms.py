"""framegraph.geometry_ms: the median, over the window frames, of a
frame's host ms in the program's ``frame.geometry`` span (the vertex
stage, triangle setup and the record table) less the spans inside it
(``program_trace.stage_ms``)."""

from h100_bench import program_trace


def read(run):
    return program_trace.stage_ms(run, "frame.geometry")
