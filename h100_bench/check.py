"""How ``correct`` is decided: the host images the timed path handed back
(a sample drawn from the seed) against the plain reference's frames of
the poses that dispatched them, once the window has closed.

A pixel is bad where a channel differs from the reference by more than
:data:`LSB_TOLERANCE` steps of 255. Four numbers, each the worst over the
compared frames:

- ``bad_px_pct``: the share of the frame's pixels (%) that are bad;
- ``mean_abs_lsb``: the mean absolute difference over every channel of
  every pixel, in steps of 255;
- ``overlay_bad_pct``: the share (%) of the pixels where the reference
  shows a light sphere or the gizmo that are bad: the overlays are a few
  thousand pixels of a frame, so the frame-wide share cannot see them;
- ``window_bad_pct``: the share (%) of bad pixels in the
  :data:`WINDOW` × :data:`WINDOW` window of the frame that holds the
  most: a fault confined to one place (a block, an overlay, a tile) that
  the frame-wide share averages away.

Each is held to the limit its configuration file states (``limits``); the
readings the limits were set from are in PERF.md.
"""

from __future__ import annotations

import numpy as np

LSB_TOLERANCE = 2
WINDOW = 16
NAMES = ("bad_px_pct", "mean_abs_lsb", "overlay_bad_pct", "window_bad_pct")


def window_max(bad: np.ndarray, k: int = WINDOW) -> int:
    """The most ``True`` pixels in any ``k`` × ``k`` window of ``bad``."""
    c = np.zeros((bad.shape[0] + 1, bad.shape[1] + 1), np.int64)
    c[1:, 1:] = bad.astype(np.int64).cumsum(0).cumsum(1)
    k = min(k, *bad.shape)
    return int((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]).max())


def frame_readings(got: np.ndarray, want: np.ndarray,
                   overlay: np.ndarray | None = None) -> dict:
    """The numbers of one (H, W, 3) uint8 frame against its reference;
    ``overlay`` (H, W) the reference's sphere and gizmo pixels."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    bad = diff.max(-1) > LSB_TOLERANCE
    k = min(WINDOW, *bad.shape)
    n_over = 0 if overlay is None else int(overlay.sum())
    return {"bad_px_pct": float(bad.mean() * 100),
            "mean_abs_lsb": float(diff.mean()),
            "overlay_bad_pct": float(bad[overlay].sum() * 100 / n_over)
            if n_over else 0.0,
            "window_bad_pct": window_max(bad, k) * 100 / (k * k)}


def readings(render, frames) -> dict:
    """Worst readings over ``frames`` = [(host image, pose), ...];
    ``render(pose)`` gives the reference frame as a uint8 array and its
    overlay mask."""
    worst = dict.fromkeys(NAMES, 0.0)
    for img, pose in frames:
        want, overlay = render(pose)
        r = frame_readings(np.asarray(img), want, overlay)
        worst = {k: max(v, r[k]) for k, v in worst.items()}
    return dict(worst, frames_compared=len(frames))


def verdict(read: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit, and at
    least one frame compared; checks maps each number to its value and
    limit."""
    checks = {k: {"value": read[k], "limit": limits[k]} for k in limits}
    checks["frames_compared"] = {"value": read["frames_compared"],
                                 "limit": 1}
    ok = read["frames_compared"] >= 1 and all(
        read[k] <= lim for k, lim in limits.items())
    return ok, checks
