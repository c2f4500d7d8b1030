"""framegraph.ibl_ms: the median, over the window frames, of a frame's
host ms in the program's ``shade.ibl`` spans (the split-sum IBL ambient
planes, inside ``frame.shade``; ``span_reads.span_ms``)."""

from h100_bench import span_reads


def read(run):
    return span_reads.span_ms(run, "shade.ibl")
