"""framegraph.shadow_launches: the mean, over the window frames, of the
program's ``shadow_launches`` counter under its ``framegraph.frame``
span (the light pass's raster and sort kernel launches, counted where
they are made; ``span_reads.count_per_frame``)."""

from h100_bench import span_reads


def read(run):
    return span_reads.count_per_frame(run, "shadow_launches")
