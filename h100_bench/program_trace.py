"""The program's own spans and counters, read after a window.

``bibim_tpu_torch.utils.profiling`` records spans and counters inside the
program on ``time.perf_counter_ns``, the host clock the window's calls
are timed on; ``snapshot()`` hands them over as records with
``seq``, ``name``, ``start_ns``, ``end_ns``, ``parent`` (the enclosing
span's ``seq``, -1 at the top), ``frame`` (the frame id, advanced by each
``Session.render``), ``detail`` and ``count`` (None on a span). A
window frame is one whose ``session.frame`` span starts inside a window
call outside the profiled segment. A program without the recorder (no
``snapshot``, or nothing in it) reads None.

Inside the profiled segment the device trace holds the benchmark's own
``render_frame`` range of each call on the profiler's clock, and the
recorder the program's ``framegraph.frame`` span of the same call: the
median difference of their starts maps one clock onto the other
(:func:`clock_offset_us`), so that each idle gap of the device can be
labelled with the program span the host was in at its middle.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass

# The five stages of render_frame, in the order they run.
STAGES = ("frame.geometry", "frame.raster", "frame.shade", "frame.overlay",
          "frame.output")
# How far the start differences of the profiled frames may spread (the
# distance between their quartiles) before the two clocks count as not
# mapped.
MAX_OFFSET_SPREAD_US = 50.0


@dataclass
class ProgramTrace:
    records: list  # every record of the snapshot, in seq order
    by_seq: dict
    frames: dict  # window frame id -> its session.frame record
    calls_s: float  # wall seconds of the window calls kept

    def in_frames(self, name: str) -> list:
        """The spans named ``name`` inside the window frames."""
        return [r for r in self.records
                if r.count is None and r.name == name
                and _inside(r, self.frames.get(r.frame))]


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def _inside(r, outer) -> bool:
    return (outer is not None and outer.start_ns <= r.start_ns
            and r.end_ns <= outer.end_ns)


_CACHE: list = [None, None]


def load(run) -> ProgramTrace | None:
    """The program's records of ``run``'s window (read once a window)."""
    if _CACHE[0] is run.window:
        return _CACHE[1]
    trace = _load(run.window)
    _CACHE[:] = [run.window, trace]
    return trace


def _load(win) -> ProgramTrace | None:
    try:
        from bibim_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    records = snapshot()
    if not records:
        return None
    calls = sorted((c.t0, c.t1) for c in window_calls(win))
    starts = [a for a, _ in calls]
    frames = {}
    for r in records:
        if r.count is None and r.name == "session.frame":
            t = r.start_ns / 1e9
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= calls[k][1]:
                frames[r.frame] = r
    return ProgramTrace(records=records, by_seq={r.seq: r for r in records},
                        frames=frames,
                        calls_s=sum(b - a for a, b in calls))


def window_calls(win) -> list:
    """The window calls that dispatched a frame, outside the profiled
    segment."""
    return [c for c in win.calls
            if c.dispatched is not None and c.dispatched not in win.profiled
            and c.t0 >= win.t_first]


def self_ns(records: list) -> dict:
    """Each span's seq -> its ns less the ns of its direct child spans."""
    out = {r.seq: r.end_ns - r.start_ns for r in records if r.count is None}
    for r in records:
        if r.count is None and r.parent in out:
            out[r.parent] -= r.end_ns - r.start_ns
    return out


def stage_ms(run, stage: str) -> float | None:
    """The median, over the window frames, of a frame's self ms of
    ``stage`` spans run directly inside its ``framegraph.frame``."""
    t = load(run)
    if t is None:
        return None
    roots = {r.seq: r.frame for r in t.in_frames("framegraph.frame")}
    own = self_ns(t.records)
    per: dict = {}
    for r in t.records:
        if r.count is None and r.name == stage and r.parent in roots:
            per[r.frame] = per.get(r.frame, 0) + own[r.seq]
    return statistics.median(per.values()) / 1e6 if per else None


def host_syncs(run) -> float | None:
    """The mean, over the window frames that ran ``framegraph.frame``, of
    ``host_syncs`` counted under it."""
    t = load(run)
    if t is None:
        return None
    roots = {r.seq: 0 for r in t.in_frames("framegraph.frame")}
    if not roots:
        return None
    for r in t.records:
        if r.count is not None and r.name == "host_syncs":
            root = _ancestor(r, roots, t.by_seq)
            if root is not None:
                roots[root] += r.count
    return sum(roots.values()) / len(roots)


def _ancestor(r, seqs, by_seq) -> int | None:
    """The seq of the nearest span enclosing ``r`` that is in ``seqs``."""
    p = r.parent
    while p >= 0 and p not in seqs:
        q = by_seq.get(p)
        if q is None:
            return None
        p = q.parent
    return p if p >= 0 else None


def retune_ms_per_s(run) -> float | None:
    """Host ms in ``session.retune`` over the window frames, per second of
    the window calls kept."""
    t = load(run)
    if t is None or t.calls_s <= 0:
        return None
    return sum(_ms(r) for r in t.in_frames("session.retune")) / t.calls_s


def span_median_ms(run, name: str) -> float | None:
    """The median ms of the ``name`` spans inside the window frames."""
    t = load(run)
    xs = [] if t is None else [_ms(r) for r in t.in_frames(name)]
    return statistics.median(xs) if xs else None


def clock_offset_us(run) -> float | None:
    """Profiler us less program us (``perf_counter_ns`` / 1000) over the
    profiled frames: the median difference between the device trace's
    ``render_frame`` range of each profiled call and the program's
    ``framegraph.frame`` span of the same call; None where the frames do
    not pair up, are fewer than 4, or their differences spread (quartile
    to quartile) over :data:`MAX_OFFSET_SPREAD_US`."""
    t, d = load(run), run.device
    if t is None or d is None:
        return None
    dev = sorted(a for name, a, _, _ in d.spans if name == "render_frame")
    calls = sorted((c.t0, c.t1) for c in run.window.calls
                   if c.dispatched in run.window.profiled)
    frames = sorted(r.start_ns for r in t.records
                    if r.count is None and r.name == "framegraph.frame"
                    and any(a <= r.start_ns / 1e9 <= b for a, b in calls))
    if len(dev) != len(frames) or len(dev) < 4:
        return None
    diffs = [a - b / 1e3 for a, b in zip(dev, frames)]
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    if q3 - q1 > MAX_OFFSET_SPREAD_US:
        return None
    return statistics.median(diffs)


def labelled_gaps(run) -> list | None:
    """The profiled segment's idle gaps as (us, the innermost program span
    at the gap's middle or None); None where the clocks do not map."""
    off = clock_offset_us(run)
    if off is None:
        return None
    t = load(run)
    gaps = [(a, b) for a, b, _ in run.device.gaps()]
    mids = [0.5 * (a + b) - off for a, b in gaps]  # program us
    label = [None] * len(gaps)
    # In start order, so that a span nested in another labels last.
    for r in sorted((r for r in t.records if r.count is None),
                    key=lambda r: r.start_ns):
        lo = bisect.bisect_left(mids, r.start_ns / 1e3)
        hi = bisect.bisect_right(mids, r.end_ns / 1e3)
        for k in range(lo, hi):
            label[k] = r
    return [(b - a, lab) for (a, b), lab in zip(gaps, label)]


def idle_ms_by_stage(run) -> dict | None:
    """The profiled segment's idle ms whose gap's middle lies in a
    ``framegraph.frame`` span, by the stage run directly inside it that
    holds the middle (None: in none of them); None where the clocks do
    not map."""
    gaps = labelled_gaps(run)
    if gaps is None:
        return None
    t = load(run)
    out = dict.fromkeys(STAGES + (None,), 0.0)
    for us, r in gaps:
        stage = None
        while r is not None and r.name != "framegraph.frame":
            stage = r if r.name in STAGES else stage
            r = t.by_seq.get(r.parent)
        if r is None:
            continue
        key = stage.name if stage is not None and stage.parent == r.seq \
            else None
        out[key] += us / 1e3
    return out


def idle_staged_pct(run) -> float | None:
    """Of the idle time whose gap's middle lies in a ``framegraph.frame``
    span, the share (%) whose middle lies in one of its five stages."""
    idle = idle_ms_by_stage(run)
    framed = None if idle is None else sum(idle.values())
    if not framed:
        return None
    return 100.0 * (framed - idle[None]) / framed


def stage_idle_ms(run, stage: str) -> float | None:
    """Device-idle ms a profiled frame while the host is in ``stage``."""
    idle = idle_ms_by_stage(run)
    if idle is None or not run.device.frames:
        return None
    return idle[stage] / run.device.frames
