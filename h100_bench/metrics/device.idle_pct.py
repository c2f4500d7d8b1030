"""device.idle_pct: the share of the profiled segment's wall time in which
no operation ran on the device, in percent."""


def read(run):
    d = run.device
    if d is None or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 - 100.0 * d.busy_s / d.window_s
