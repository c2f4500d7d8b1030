"""viewer.frame_p95_ms: the nearest-rank 95th percentile, over every frame
dispatched in the traced window, of the ms from the start of the call
that dispatched it to the end of the call that handed its image back
(none where a frame never came back); per layer for the reason
``viewer.frames_per_s`` is."""

from h100_bench import timeline


def read(run):
    w = run.window
    return timeline.summarize(w.calls, w.dropped, w.window_s)["frame_p95_ms"]
