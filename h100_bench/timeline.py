"""End-to-end arithmetic of one measured window, from what the viewer loop
recorded: each ``Session.render`` call's start and end, the frame it
dispatched and the frames whose host images it handed back.

- ``frames_per_s``: host images handed back during the window over the
  window's wall seconds (all the work over all the time).
- ``frame_p95_ms``: the 95th percentile (nearest rank), over every frame
  dispatched in the window, of the time from the start of the call that
  dispatched the frame to the end of the call that handed back its image;
  a frame that never came back counts as failed and has no latency, so
  the percentile is given only where every frame came back. The tail
  wants at least 200 frames in the window, so that ten lie beyond it.

Both follow the speed of the host's CPU (the loop is host-bound), so
``BENCHMARK.json`` reads them per layer (``viewer.*``) from traced runs.
- ``failed``: frames whose diagnostics reported dropped geometry, and
  frames that never came back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

@dataclass
class Call:
    """One loop call: host clock at its start and end (seconds), the
    frame it dispatched (None for the drain at the window's end) and the
    frames it handed back."""

    t0: float
    t1: float
    dispatched: int | None
    returned: list = field(default_factory=list)


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def summarize(calls: list, dropped: set, window_s: float) -> dict:
    """``calls`` in order; ``dropped``: frames whose diagnostics reported
    drops; ``window_s``: the window's wall seconds (first call's start to
    the drain's end). Returns attempted, failed, returned, frames_per_s,
    frame_p95_ms (None if a frame never came back) and the latencies in
    ms by frame."""
    start = {c.dispatched: c.t0 for c in calls if c.dispatched is not None}
    done = {}
    for c in calls:
        for f in c.returned:
            if f in done:
                raise ValueError(f"frame {f} handed back twice")
            done[f] = c.t1
    latency = {f: (done[f] - t0) * 1e3 for f, t0 in start.items()
               if f in done}
    lost = set(start) - set(done)
    attempted = len(start)
    return dict(
        attempted=attempted,
        failed=len(lost | (set(dropped) & set(start))),
        returned=len(done),
        frames_per_s=len(done) / window_s,
        frame_p95_ms=(nearest_rank(latency.values(), 0.95)
                       if latency and not lost else None),
        latency_ms=latency,
    )
