"""session.host_ms: the median host ms of ``Session.render`` less the
calls it makes into the layers below (``render_frame``, the autotune,
``readback.submit``): the session's own work a frame (camera, scene
update, view block uploads, the HUD, the drop watcher)."""

import statistics

from h100_bench.tracing import self_ms


def read(run):
    xs = self_ms(run.spans, "Session.render")
    return statistics.median(xs) if xs else None
