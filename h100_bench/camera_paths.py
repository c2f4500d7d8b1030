"""The camera paths a traffic mix drives, drawn from ``--seed``: one pose
(position, yaw, pitch in degrees) per frame, a function of the frame's
index alone, so that one seed gives the same frames whatever the speed of
the run. The path's parameters are redrawn at the start of every segment
of ``segment_s`` seconds of path time (``dt`` seconds a frame).

Every seed draws the same segments in another order, so that the seed
orders the work and does not size it: each drawn quantity takes the
midpoints of ``strata`` equal slices of its range, paired with the other
quantities' into ``strata`` segments by a fixed arrangement (the same
for every seed), and each seed deals that deck of segments in its own
order, shuffled anew each time the deck runs out. Only the start (the
orbit's yaw, the pan's position) and the orbit's turning sense are drawn
freely.

Kinds:

- ``orbit``: the camera looks at ``centre`` from ``radius`` away (the
  viewer's ``--orbit``: position = centre - look · radius); each segment
  draws the radius, the pitch and the yaw rate in degrees a frame; the
  yaw runs on from segment to segment, turning the way drawn for each
  segment, or, where the mix sets ``"sense": "path"``, the way drawn once
  for the whole path.
- ``pan``: the camera glides over the ground plane at ``height`` above it,
  pitched down by ``pitch_deg``, heading along its yaw at ``speed`` units
  a frame; each segment draws the height, pitch, speed and heading; the
  position reflects off the edges of the ``box`` (x and z bounds).

A mix gives how the camera moves; the configuration gives where its
scene is (:data:`SCENE_KEYS` under ``camera``: the orbit's centre and
radius, the ground plane's height), and nothing else.
"""

from __future__ import annotations

import itertools

import numpy as np


def _look(yaw: float, pitch: float) -> np.ndarray:
    yaw, pitch = np.radians(yaw), np.radians(pitch)
    cp = np.cos(pitch)
    return np.asarray([-np.sin(yaw) * cp, np.sin(pitch), np.cos(yaw) * cp])


# The drawn quantities of each kind, in the order their strata are paired.
QUANTITIES = {"orbit": ("radius", "pitch_deg", "yaw_rate_deg"),
              "pan": ("height", "pitch_deg", "speed", "heading_deg")}
# What a configuration's ``camera`` gives: where its scene is.
SCENE_KEYS = ("centre", "radius", "plane_y")


def merged_params(path: dict, config: dict) -> dict:
    """The mix's path parameters and the configuration's scene keys."""
    camera = config.get("camera", {})
    extra = set(camera) - set(SCENE_KEYS)
    both = set(camera) & set(path)
    if extra or both:
        raise ValueError(f"configuration {config.get('name')!r}: camera "
                         f"keys {sorted(extra | both)} belong to no "
                         "configuration or to the traffic mix")
    return {**path, **camera}


class CameraPath:
    """Poses of frames 0, 1, 2, ... of one seed's path."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.kind = params["kind"]
        if self.kind not in ("orbit", "pan"):
            raise ValueError(f"unknown camera path kind {self.kind!r}")
        self.seg = max(1, round(params["segment_s"] / params["dt"]))
        self.strata = int(params["strata"])
        self.rng = np.random.default_rng(seed)
        self.poses: list = []
        self._state = None
        self._deck: list = []

    def _segment(self) -> dict:
        """The next segment of the deck (see the module's docstring)."""
        if not self._deck:
            k = self.strata
            keys = [q for q in QUANTITIES[self.kind] if q in self.p]
            deck = []
            for j in range(k):
                seg = {}
                for n, q in enumerate(keys):
                    lo, hi = self.p[q]
                    stratum = np.random.default_rng(n).permutation(k)[j]
                    seg[q] = lo + (hi - lo) * (stratum + 0.5) / k
                deck.append(seg)
            self._deck = [deck[j] for j in self.rng.permutation(k)]
        seg = dict(self._deck.pop())
        if self.kind == "orbit" and self.p.get("sense") != "path":
            seg["sense"] = self._sense()
        return seg

    def _sense(self) -> float:
        return 1.0 if self.rng.random() < 0.5 else -1.0

    def _start(self) -> dict:
        if self.kind == "orbit":
            start = dict(yaw=float(self.rng.uniform(0.0, 360.0)))
            if self.p.get("sense") == "path":
                start["sense"] = self._sense()
            return start
        (x0, x1), (z0, z1) = self.p["box"]
        return dict(x=float(self.rng.uniform(x0, x1)),
                    z=float(self.rng.uniform(z0, z1)))

    def _next(self, i: int):
        if self._state is None:
            self._state = self._start()
        if i % self.seg == 0:
            self._state.update(self._segment())
        st = self._state
        if self.kind == "orbit":
            if i:
                st["yaw"] += st["sense"] * st["yaw_rate_deg"]
            st["yaw"] %= 360.0
            look = _look(st["yaw"], st["pitch_deg"])
            pos = np.asarray(self.p["centre"]) - look * st["radius"]
            return (tuple(float(x) for x in pos), float(st["yaw"]),
                    float(st["pitch_deg"]))
        if i:
            h = np.radians(st["heading_deg"])
            st["x"] -= np.sin(h) * st["speed"]
            st["z"] += np.cos(h) * st["speed"]
            for axis, (lo, hi) in zip(("x", "z"), self.p["box"]):
                if not lo <= st[axis] <= hi:
                    st[axis] = min(max(st[axis], lo), hi)
                    # Reflect the heading off this edge.
                    st["heading_deg"] = ((-st["heading_deg"]) if axis == "x"
                                         else 180.0 - st["heading_deg"]) \
                        % 360.0
        y = self.p["plane_y"] + st["height"]
        return ((float(st["x"]), float(y), float(st["z"])),
                float(st["heading_deg"]), float(st["pitch_deg"]))

    def pose(self, i: int) -> tuple:
        """(position, yaw, pitch) of frame ``i``."""
        while len(self.poses) <= i:
            self.poses.append(self._next(len(self.poses)))
        return self.poses[i]


def warmup_poses(params: dict) -> list:
    """The coarse pass over the path's whole range of poses that set-up
    renders: a grid of ``warmup`` steps over each drawn range (the orbit
    also over the full circle of yaw), independent of the seed."""
    steps = params["warmup"]

    def grid(key):
        lo, hi = params[key]
        n = steps[key]
        return [lo] if n == 1 else list(np.linspace(lo, hi, n))

    if params["kind"] == "orbit":
        yaws = np.linspace(0.0, 360.0, steps["yaw"], endpoint=False)
        out = []
        for yaw, pitch, radius in itertools.product(yaws, grid("pitch_deg"),
                                                    grid("radius")):
            pos = np.asarray(params["centre"]) - _look(yaw, pitch) * radius
            out.append((tuple(float(x) for x in pos), float(yaw),
                        float(pitch)))
        return out
    (x0, x1), (z0, z1) = params["box"]
    out = []
    for k, (height, pitch) in enumerate(itertools.product(
            grid("height"), grid("pitch_deg"))):
        heading = 360.0 * k / max(1, steps["height"] * steps["pitch_deg"])
        out.append(((0.5 * (x0 + x1), params["plane_y"] + float(height),
                     0.5 * (z0 + z1)), heading, float(pitch)))
    return out
