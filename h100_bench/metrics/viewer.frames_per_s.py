"""viewer.frames_per_s: host images handed back in the traced window over
its wall seconds, the profiled segment included: what the user of the
viewer sees, read per layer because it follows the speed of the host's
CPU, which differs from machine to machine far more than a bound
could hold."""

from h100_bench import timeline


def read(run):
    w = run.window
    return timeline.summarize(w.calls, w.dropped, w.window_s)["frames_per_s"]
