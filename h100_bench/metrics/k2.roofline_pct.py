"""k2.roofline_pct: the profiled segment's frames' K2 bound
(``roofline/k2.py``, at the H100 SXM peaks) over K2's device time there,
in percent."""


def read(run):
    if run.device is None:
        return None
    t = run.kernel_s("K2")
    return 100.0 * run.bound_s("k2") / t if t > 0 else None
