"""The ``offline`` driver: a known camera path rendered through
``Session`` at the configuration's size, every frame handed back, as a
sequence render (a turntable of an asset) does.

The loop is the ``viewer`` driver's (:func:`viewer.run`): one session at
readback depth ``readback_depth``, the next ``Session.render`` as soon as
the last returned (a closed loop), the same warm-up, window, profiles and
:class:`viewer.Window`. The session draws what the configuration turns on
beyond the viewer's frame: ``shadows`` and ``ibl`` (``UiState``'s
``enable_shadows`` and ``enable_ibl``); a program without those toggles
refuses the configuration as the session is made, before any frame. A
traced window also keeps each kernel the profiled segment launched
(``Window.launches``: the launch call's start, the kernel's name, its
device interval and the call's name, on the profiler's clock), so that a
kernel's time can be put down to the program span its launch fell in.
"""

from __future__ import annotations

import collections
import dataclasses

from h100_bench.drivers import viewer

# The runtime calls that launch a kernel.
LAUNCH_PREFIX = "cudaLaunch"
_VIEWER_SESSION = viewer.make_session
_VIEWER_STOP = viewer._stop


def make_session(config: dict, traffic: dict, device: str):
    """The viewer's session with the configuration's ``shadows`` and
    ``ibl``; its light pass must be the one the configuration states."""
    session = _VIEWER_SESSION(config, traffic, device)
    session.ui = dataclasses.replace(session.ui,
                                     enable_shadows=config["shadows"],
                                     enable_ibl=config["ibl"])
    s = session.settings()
    if config["shadows"] and (s.shadow_size, s.shadow_bias, s.shadow_light) \
            != (config["shadow_size"], config["shadow_bias"],
                config["shadow_light"]):
        raise ValueError(
            f"the session renders a {s.shadow_size}² shadow map of light "
            f"{s.shadow_light} at bias {s.shadow_bias}; the configuration "
            "states another")
    return session


def kernel_launches(prof) -> list:
    """(launch call start us, kernel name, kernel start us, kernel end
    us, launch call name) of each kernel of a finished
    ``torch.profiler.profile``, paired by correlation id with the runtime
    call that launched it (``cudaLaunchKernel``; ``cudaLaunchKernelExC``
    for a cluster launch, ``cudaLaunchCooperativeKernel``), on the clock
    of :func:`tracing.read_profile`."""
    from torch.autograd import DeviceType

    calls, kernels = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.append(e)
        elif e.name.startswith(LAUNCH_PREFIX):
            calls[e.id] = (e.time_range.start, e.name)
    return [(calls[k.id][0], k.name, k.time_range.start, k.time_range.end,
             calls[k.id][1]) for k in kernels if k.id in calls]


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, log=print) -> viewer.Window:
    launches = []

    def stop(prof, spans, seg, i):
        out = _VIEWER_STOP(prof, spans, seg, i)
        launches.extend(kernel_launches(out[0]))
        return out

    # The viewer's loop, with this driver's session and the profiled
    # segment's launches kept as it stops.
    viewer.make_session, viewer._stop = make_session, stop
    try:
        win = viewer.run(config, traffic, seed, seconds, trace, device, log)
    finally:
        viewer.make_session, viewer._stop = _VIEWER_SESSION, _VIEWER_STOP
    win.launches = launches or None
    if launches:
        by_call = collections.Counter(call for *_, call in launches)
        log(f"profiled segment: {len(launches)} kernels paired with their "
            f"launch calls ({dict(by_call)})")
    return win
