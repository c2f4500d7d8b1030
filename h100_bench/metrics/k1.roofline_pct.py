"""k1.roofline_pct: the profiled segment's frames' K1 bound
(``roofline/k1.py``: every raster pass, at the H100 SXM peaks) over K1's
device time there (every launch), in percent."""


def read(run):
    if run.device is None:
        return None
    t = run.kernel_s("K1")
    return 100.0 * run.bound_s("k1") / t if t > 0 else None
