"""framegraph.pcf_ms: the median, over the window frames, of a frame's
host ms in the program's ``shade.pcf`` span (the screen pixels' 2 x 2 PCF
visibility of the shadow-casting light, inside ``frame.shade``;
``span_reads.span_ms``)."""

from h100_bench import span_reads


def read(run):
    return span_reads.span_ms(run, "shade.pcf")
