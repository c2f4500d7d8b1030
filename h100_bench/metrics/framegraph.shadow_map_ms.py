"""framegraph.shadow_map_ms: the median, over the window frames, of a
frame's host ms in the program's ``shade.shadow_map`` span (the light
pass: the light's frustum, setup, records, binning and raster, inside
``frame.shade``; ``span_reads.span_ms``)."""

from h100_bench import span_reads


def read(run):
    return span_reads.span_ms(run, "shade.shadow_map")
