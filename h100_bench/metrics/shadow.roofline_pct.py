"""shadow.roofline_pct: the profiled segment's frames' bound of the light
pass's raster (``roofline/shadow.py``, at the H100 SXM peaks) over the
device time of the K1 launches made inside the program's
``shade.shadow_map`` span there (``span_reads.kernel_s_in_span``), in
percent."""

from h100_bench import span_reads


def read(run):
    if run.device is None:
        return None
    t = span_reads.kernel_s_in_span(run, "K1", "shade.shadow_map")
    return 100.0 * run.bound_s("shadow") / t if t else None
