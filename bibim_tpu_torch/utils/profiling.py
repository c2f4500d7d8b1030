"""Host spans and counters of the frame loop, and the loop's FPS counter.

- :func:`stage_scope` times a named stage of the host's work on
  ``time.perf_counter_ns``; :func:`count` adds to a named counter at the
  point where the counted event happens (``host_syncs``: a blocking
  device→host read or a synchronous pageable host→device copy)
- :func:`next_frame` starts a new frame id (``Session.render`` calls it);
  every span and count records the frame id of its thread
- :func:`snapshot` copies the records out, oldest first; another thread
  may take it while the loop records
- :class:`FrameStats`: the rolling FPS / ms counter of the host loop

Records live in a ring of :data:`RING_SIZE` slots allocated once; the
newest overwrite the oldest. The recorder is on by default; while
:func:`set_enabled` has it off, :func:`stage_scope` returns one shared
no-op and :func:`count` returns at once. Spans never enter
``torch.profiler`` or NVTX, so a device trace shows only device work.
"""

from __future__ import annotations

import itertools
import operator
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

RING_SIZE = 1 << 17

_now = time.perf_counter_ns
_seq_of = operator.itemgetter(0)


class Record(NamedTuple):
    """One span or counter event. ``parent`` is the ``seq`` of the
    enclosing span (-1 at the top). A span has ``count`` None and may
    carry a ``detail`` tuple; a counter event has ``start_ns ==
    end_ns`` and its ``count``."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame: int
    detail: tuple | None
    count: int | None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Noop:
    """The span of a disabled recorder. Its ``__enter__`` and ``__exit__``
    are a C function, so that entering and leaving it runs no Python
    frame: ``"".format`` ignores its arguments and returns ``""``, which
    is false, so an exception raised inside the block propagates."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_NOOP = _Noop()


class _Open:
    """One thread's open spans. :meth:`Recorder.stage_scope` pushes a span
    on ``stack`` and returns this object; leaving the ``with`` block pops
    the innermost span and writes its record. ``state`` = [the innermost
    open span's seq, the frame id]."""

    __slots__ = ("stack", "state", "ring", "mask")
    __enter__ = "".format  # the span opened when stage_scope was called

    def __init__(self, ring: list, mask: int):
        self.stack = []
        self.state = [-1, -1]
        self.ring = ring
        self.mask = mask

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        seq, name, t0, parent, frame, detail = self.stack.pop()
        self.state[0] = parent
        self.ring[seq & self.mask] = (seq, name, t0, t1, parent, frame,
                                      detail, None)
        return False


class _Thread(threading.local):
    def __init__(self, ring: list, mask: int):
        self.open = _Open(ring, mask)


class Recorder:
    """Spans and counters in a ring of ``size`` slots (a power of two)."""

    def __init__(self, size: int = RING_SIZE):
        if size < 1 or size & (size - 1):
            raise ValueError(f"ring size must be a power of two, got {size}")
        self._ring = [None] * size
        self._mask = size - 1
        self._next = itertools.count().__next__
        self._frames = itertools.count().__next__
        self._thread = _Thread(self._ring, self._mask)
        self._enabled = True

    def stage_scope(self, name: str, detail: tuple | None = None):
        """Record the block of the ``with`` statement this call heads as
        span ``name`` (the span opens at the call)."""
        if not self._enabled:
            return _NOOP
        open_ = self._thread.open
        state = open_.state
        seq = self._next()
        open_.stack.append((seq, name, _now(), state[0], state[1], detail))
        state[0] = seq
        return open_

    def count(self, name: str, n: int = 1) -> None:
        """Record ``n`` more of counter ``name`` inside the open span."""
        if not self._enabled:
            return
        parent, frame = self._thread.open.state
        seq = self._next()
        t = _now()
        self._ring[seq & self._mask] = (seq, name, t, t, parent, frame, None,
                                        n)

    def next_frame(self) -> int:
        """Start the calling thread's next frame id and return it."""
        self._thread.open.state[1] = f = self._frames()
        return f

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def snapshot(self, last: int | None = None) -> list:
        """The records, as :class:`Record`, in ``seq`` order; spans
        still open are left out. With ``last``, only those among the
        newest ``last`` seqs issued, read from their slots alone."""
        if last is None:
            ring = self._ring[:]  # one copy under the interpreter lock
            rows = sorted(filter(None, ring), key=_seq_of)
        else:
            # Taking a seq gives the newest issued; a slot whose seq
            # differs holds an older lap's record (its span is open).
            n, ring, mask = self._next(), self._ring, self._mask
            rows = [r for s in range(max(0, n - last), n)
                    if (r := ring[s & mask]) is not None and r[0] == s]
        return [Record._make(r) for r in rows]


RECORDER = Recorder()
stage_scope = RECORDER.stage_scope
count = RECORDER.count
next_frame = RECORDER.next_frame
set_enabled = RECORDER.set_enabled
snapshot = RECORDER.snapshot

# The five stages of ``render_frame``, in the order they run.
FRAME_STAGES = ("frame.geometry", "frame.raster", "frame.shade",
                "frame.overlay", "frame.output")


def self_ns(records: list) -> dict:
    """Each span's ``seq`` → its ns less the ns its direct child spans
    cover."""
    out = {r.seq: r.end_ns - r.start_ns for r in records if r.count is None}
    for r in records:
        if r.count is None and r.parent in out:
            out[r.parent] -= r.end_ns - r.start_ns
    return out


def stage_medians(records: list, frames: int = 60) -> dict:
    """Over the newest ``frames`` ``framegraph.frame`` spans in
    ``records``: the median self ms of each of :data:`FRAME_STAGES` run
    directly inside them (``<stage>_ms``), and the median ``host_syncs``
    counted under them."""
    by_seq = {r.seq: r for r in records}
    roots = {r.seq for r in records
             if r.name == "framegraph.frame" and r.count is None}
    roots = set(sorted(roots)[-frames:])
    own = self_ns(records)
    stage_ns = {s: {} for s in FRAME_STAGES}
    syncs = dict.fromkeys(roots, 0)
    for r in records:
        if r.count is None:
            if r.name in stage_ns and r.parent in roots:
                per = stage_ns[r.name]
                per[r.parent] = per.get(r.parent, 0) + own[r.seq]
        elif r.name == "host_syncs":
            root = _ancestor(r, roots, by_seq)
            if root is not None:
                syncs[root] += r.count
    out = {s.split(".", 1)[1] + "_ms":
           (statistics.median(v.values()) / 1e6 if v else None)
           for s, v in stage_ns.items()}
    out["host_syncs"] = statistics.median(syncs.values()) if syncs else None
    return out


def _ancestor(r: Record, seqs: set, by_seq: dict) -> int | None:
    """The seq of ``r``'s nearest enclosing span that is in ``seqs``."""
    p = r.parent
    while p >= 0 and p not in seqs:
        q = by_seq.get(p)
        if q is None:
            return None
        p = q.parent
    return p if p >= 0 else None


@dataclass
class FrameStats:
    """Rolling frame-time statistics for the host loop."""

    window: int = 60
    _times: list = field(default_factory=list)
    _last: float | None = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        if dt > 0:
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        return dt

    @property
    def ms_per_frame(self) -> float:
        if not self._times:
            return 0.0
        return 1e3 * sum(self._times) / len(self._times)

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1e3 / ms if ms > 0 else 0.0

    def summary(self) -> str:
        return f"{self.ms_per_frame:.2f} ms/frame ({self.fps:.1f} fps)"
