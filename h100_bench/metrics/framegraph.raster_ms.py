"""framegraph.raster_ms: the median, over the window frames, of a frame's
host ms in the program's ``frame.raster`` span (binning, its compactions
and the raster passes) less the spans inside it
(``program_trace.stage_ms``)."""

from h100_bench import program_trace


def read(run):
    return program_trace.stage_ms(run, "frame.raster")
