"""framegraph.overlay_ms: the median, over the window frames, of a frame's
host ms in the program's ``frame.overlay`` span (the LDR scatter, light
spheres, HUD, untile, TBN lines and gizmo) less the spans inside it
(``program_trace.stage_ms``)."""

from h100_bench import program_trace


def read(run):
    return program_trace.stage_ms(run, "frame.overlay")
