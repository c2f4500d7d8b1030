"""The ``viewer`` driver: the interactive viewer's loop as users drive it.

One ``bibim_tpu_torch.host.session.Session`` on the configuration's scene
and frame settings, its readback ``readback_depth`` deep; every frame the
camera is set to the path's pose and ``Session.render`` is called as soon
as the previous call returned (a closed loop, one client). Set-up renders
the coarse pass over the path's range (:func:`camera_paths.warmup_poses`)
so that the caps the window needs exist, then the window runs for the
given seconds and ends by draining the frames in flight and waiting for
the device. An untraced window on a device runs under a CUDA-only
``torch.profiler`` from its first launch to that wait, for the device's
busy seconds (``frame_device_ms``); a traced one profiles a segment
with the host's spans instead.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np

from h100_bench import camera_paths, timeline, tracing

SPAN_NAMES = ("Session.render", "render_frame", "autotune",
              "readback.submit")


@dataclass
class Window:
    """What one window recorded."""

    calls: list
    dropped: set
    window_s: float
    t_first: float
    poses: list
    sample: list  # (frame, host image) pairs
    retunes: int  # Session.retunes gained in the window
    memory_peak_bytes: int
    spans: list = field(default_factory=list)  # outside the profiled part
    device: tracing.DeviceTrace | None = None
    profiled: range = range(0)
    # Device-busy seconds of the whole window (untraced runs on a device).
    device_busy_s: float | None = None


def make_session(config: dict, traffic: dict, device: str):
    from bibim_tpu_torch.host.gui import UiState
    from bibim_tpu_torch.host.session import Session

    if config["scene"] != "shaderball" or config["lights"] != "shaderball":
        raise ValueError("the viewer driver runs the ShaderBall scene")
    if not (config["show_lights"] and config["show_gizmo"]):
        raise ValueError("the viewer always draws the light spheres and "
                         "the gizmo")
    ui = UiState(scene="shaderball", deferred=config["deferred"],
                 enable_normal_map=config["normal_map"],
                 enable_tone_mapping=config["tone_map"],
                 exposure=config["exposure"], show_hud=traffic["hud"],
                 selected_material=config["material_index"],
                 num_instances=config["num_instances"])
    return Session(width=config["width"], height=config["height"], ui=ui,
                   readback_depth=traffic["readback_depth"], device=device)


def set_pose(session, pose) -> None:
    pos, yaw, pitch = pose
    session.camera.pos = np.asarray(pos, np.float32)
    session.camera.yaw = float(yaw)
    session.camera.pitch = float(pitch)


class _Reservoir:
    """A uniform sample of ``k`` of the images handed back, drawn from the
    seed; each kept image is copied into a buffer allocated in set-up."""

    def __init__(self, k: int, shape, seed: int):
        self.buf = np.zeros((k,) + tuple(shape), np.uint8)
        self.frames = [None] * k
        self.rng = np.random.default_rng([seed, 1])
        self.seen = 0

    def offer(self, frame: int, img) -> None:
        k = len(self.frames)
        j = self.seen if self.seen < k else int(
            self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if j < k:
            np.copyto(self.buf[j], img)
            self.frames[j] = frame

    def items(self) -> list:
        return sorted((f, self.buf[j]) for j, f in enumerate(self.frames)
                      if f is not None)


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, log=print) -> Window:
    import torch

    from bibim_tpu_torch.host import session as session_mod
    from bibim_tpu_torch.pipeline import autotune as autotune_mod

    params = camera_paths.merged_params(traffic["path"], config)
    path = camera_paths.CameraPath(params, seed)
    dt = params["dt"]
    depth = traffic["readback_depth"]
    spans = tracing.Spans()
    patched = []
    if trace:
        for mod, attr, name in ((session_mod, "render_frame", "render_frame"),
                                (autotune_mod, "autotune_settings",
                                 "autotune")):
            patched.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, spans.wrap(name, getattr(mod, attr)))
    try:
        session = make_session(config, traffic, device)
        if trace:
            session.readback.submit = spans.wrap("readback.submit",
                                                 session.readback.submit)
        for pose in camera_paths.warmup_poses(params) + [path.pose(0)]:
            set_pose(session, pose)
            session.render(dt)
        if device != "cpu":
            # The profiler's own start-up (CUPTI) belongs to set-up.
            with _profiler(cpu=trace):
                session.render(dt)
        session.flush()
        log(f"warm-up: {len(session.retunes)} tunes")
        sample = _Reservoir(traffic["check_frames"],
                            (config["height"], config["width"], 3), seed)
        calls, dropped = [], set()
        retunes0 = len(session.retunes)
        prof, finished, profiled, seg, seg_s = None, None, range(0), None, 0.0
        if device != "cpu":
            torch.cuda.synchronize()
        # Write back what set-up wrote (a stand-in root, the program's
        # asset cache) now, and not in the window.
        os.sync()
        # An untraced window records the device's work from its first
        # launch to its last, for the device ms a frame.
        whole = None
        if not trace and device != "cpu":
            whole = _profiler(cpu=False)
            whole.__enter__()
        t_first = time.perf_counter()
        i = 0
        while True:
            pose = path.pose(i)
            set_pose(session, pose)
            spans.frame = i
            n_tunes = len(session.retunes)
            t0 = time.perf_counter()
            with (spans.span("Session.render") if trace
                  else contextlib.nullcontext()):
                img = session.render(dt)
            t1 = time.perf_counter()
            back = i - (depth - 1)
            calls.append(timeline.Call(t0, t1, i, [back] if img is not None
                                       else []))
            if img is not None:
                if len(session.retunes) > n_tunes:
                    dropped.add(back)
                sample.offer(back, img)
            i += 1
            if trace and device != "cpu":
                if prof is None and seg is None and t1 - t_first >= min(
                        traffic["profile_after_s"], seconds / 3):
                    torch.cuda.synchronize()
                    prof = _profiler()
                    prof.__enter__()
                    spans.profiling = True
                    seg = [i, time.perf_counter()]
                elif prof is not None and (time.perf_counter() - seg[1]
                                           >= traffic["profile_s"]):
                    finished, profiled, seg_s = _stop(prof, spans, seg, i)
                    prof = None
            # A traced window runs on until its profiled segment is over.
            if t1 - t_first >= seconds and prof is None:
                break
        t0 = time.perf_counter()
        tail = session.readback.flush()
        session.flush()
        if device != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        first = i - len(tail)
        calls.append(timeline.Call(t0, t1, None,
                                   list(range(first, i))))
        for f, (img, diag) in enumerate(tail, start=first):
            if np.asarray(diag).any():
                dropped.add(f)
            sample.offer(f, img)
        window_s = t1 - t_first
        busy_s = None
        if whole is not None:
            ts = time.perf_counter()
            whole.__exit__(None, None, None)
            tr = time.perf_counter()
            busy_s = tracing.device_busy_s(whole)
            del whole
            log(f"device trace of the window: stopped in {tr - ts:.1f} s, "
                f"read in {time.perf_counter() - tr:.1f} s")
        peak = (torch.cuda.max_memory_allocated(torch.device(device))
                if device != "cpu" else 0)
        win = Window(calls=calls, dropped=dropped, window_s=window_s,
                     t_first=t_first,
                     poses=[path.pose(f) for f in range(i)],
                     sample=sample.items(),
                     retunes=len(session.retunes) - retunes0,
                     memory_peak_bytes=peak, device_busy_s=busy_s)
        if trace:
            win.spans = [s for s in spans.spans
                         if s.frame >= 0 and s.frame not in profiled]
            win.profiled = profiled
            if profiled:
                win.device = tracing.read_profile(
                    finished, SPAN_NAMES, len(profiled), seg_s)
        del session
        return win
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def _profiler(cpu: bool = True):
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


def _stop(prof, spans, seg, i):
    """End the profiled segment after frame ``i - 1``: wait for the
    device and stop the profiler. Returns (the profiler, the segment's
    frames, its wall seconds)."""
    import torch

    torch.cuda.synchronize()
    seg_s = time.perf_counter() - seg[1]
    prof.__exit__(None, None, None)
    spans.profiling = False
    return prof, range(seg[0], i), seg_s
