"""k5.roofline_pct: the profiled segment's frames' K5 bound
(``roofline/k5.py``, at the H100 SXM peaks) over K5's device time there,
in percent."""


def read(run):
    if run.device is None:
        return None
    t = run.kernel_s("K5")
    return 100.0 * run.bound_s("k5") / t if t > 0 else None
