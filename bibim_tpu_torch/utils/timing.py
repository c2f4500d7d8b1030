"""High-resolution timing (a copy of ``bibim_tpu.utils.timing``, the
reference's util.h:52-55, util.cpp:15-24)."""

from __future__ import annotations

import time


def get_current_time() -> float:
    """Monotonic seconds (QueryPerformanceCounter analog)."""
    return time.perf_counter()


def get_elapsed_time_in_seconds(start: float, end: float) -> float:
    return end - start


class Stopwatch:
    """Frame-delta helper used by the host frame loop (main.cpp:1149-1151)."""

    def __init__(self) -> None:
        self._last = get_current_time()

    def tick(self) -> float:
        now = get_current_time()
        dt = now - self._last
        self._last = now
        return dt
