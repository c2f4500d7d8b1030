"""The readers of the program's own spans (``program_trace.py`` and the
metrics that use it) on a synthetic window, device trace and recorder
snapshot: each reader's value, None where the program has no recorder,
and the clock offset recovered from a known shift."""

import pytest

from h100_bench import cells, program_trace, timeline, tracing
from h100_bench.drivers.viewer import Window
from h100_bench.harness import RunData

NEW = ("framegraph.geometry_ms", "framegraph.raster_ms",
       "framegraph.shade_ms", "framegraph.overlay_ms",
       "framegraph.output_ms", "framegraph.host_syncs", "autotune.ms_per_s",
       "readback.sync_ms", "framegraph.idle_staged_pct", "readback.queue_ms",
       "framegraph.geometry_idle_ms", "framegraph.raster_idle_ms",
       "framegraph.shade_idle_ms", "framegraph.overlay_idle_ms",
       "framegraph.output_idle_ms")
# Host ms of each stage in every synthetic frame; frame.raster holds a
# 1 ms child span, so its self time is 4 ms.
STAGE_MS = {"frame.geometry": 2.0, "frame.raster": 5.0, "frame.shade": 3.0,
            "frame.overlay": 8.0, "frame.output": 0.5}
FRAMES = 10
PROFILED = range(4, 8)
SHIFT_US = 5_000_000.0  # profiler us less program us
LEAD_US = 3.0  # the benchmark's render_frame range opens this earlier
T0_S = 1000.0
CALL_S = 0.04


def _records():
    """A frame id per call i = frame i, on the program's ns clock:
    session.frame from 1 ms into the call to 1 ms before its end, holding
    framegraph.frame (from 2 ms in: 0.1 ms, the stages end to end, 0.1
    ms), readback.queue (0.5 ms), readback.wait (0.3 ms), host_syncs (1 in the shade stage, 1
    under framegraph.frame, 1 under session.frame only); frame 3
    retunes for 4 ms first."""
    from bibim_tpu_torch.utils.profiling import Record

    out, seq = [], [0]

    def add(name, a, b, parent, frame, detail=None, count=None):
        s = seq[0]
        seq[0] += 1
        out.append(Record(s, name, int(a), int(b), parent, frame, detail,
                          count))
        return s

    ms = 1_000_000
    for f in range(FRAMES):
        t = int((T0_S + f * 0.05) * 1e9)
        root = add("session.frame", t + ms, t + int(CALL_S * 1e9) - ms, -1,
                   f)
        c = t + 2 * ms
        if f == 3:
            add("session.retune", c, c + 4 * ms, root, f, ("first_bind",))
            c += 4 * ms
        add("host_syncs", c, c, root, f, count=1)
        fg_end = c + int(0.2 * ms + sum(STAGE_MS.values()) * ms)
        fg = add("framegraph.frame", c, fg_end, root, f)
        c += int(0.1 * ms)
        for name, d in STAGE_MS.items():
            st = add(name, c, c + int(d * ms), fg, f)
            if name == "frame.raster":
                add("raster.pass", c, c + ms, st, f)
            if name == "frame.shade":
                add("host_syncs", c + 1, c + 1, st, f, count=1)
            c += int(d * ms)
        add("host_syncs", c, c, fg, f, count=1)
        add("readback.queue", fg_end + int(0.4 * ms), fg_end + int(0.9 * ms),
            root, f)
        add("readback.wait", fg_end + ms, fg_end + int(1.3 * ms), root, f)
    return out


def _run(spread_us=0.0):
    calls = [timeline.Call(T0_S + f * 0.05, T0_S + f * 0.05 + CALL_S, f,
                           [f - 1] if f else []) for f in range(FRAMES)]
    calls.append(timeline.Call(T0_S + 0.5, T0_S + 0.51, None, [FRAMES - 1]))
    recs = _records()
    fg = {r.frame: r for r in recs if r.name == "framegraph.frame"}
    stage = {(r.frame, r.name): r for r in recs if r.name in STAGE_MS}

    def dev_us(ns):
        return ns / 1e3 + SHIFT_US

    spans = []
    for i, f in enumerate(PROFILED):
        a = dev_us(fg[f].start_ns) - LEAD_US + (spread_us if i % 2 else 0)
        spans.append(("render_frame", a, dev_us(fg[f].end_ns), 1))
    # Device work everywhere but four gaps a profiled frame: 100 us around
    # the middle of frame.raster, 60 around frame.overlay's, 50 at the
    # start of framegraph.frame (before frame.geometry) and 200 after it.
    gaps = []
    for f in PROFILED:
        for key, us in (("frame.raster", 100.0), ("frame.overlay", 60.0)):
            r = stage[(f, key)]
            mid = dev_us(0.5 * (r.start_ns + r.end_ns))
            gaps.append((mid - us / 2, mid + us / 2))
        a = dev_us(fg[f].start_ns)
        gaps.append((a + 20.0, a + 70.0))
        b = dev_us(fg[f].end_ns)
        gaps.append((b + 100.0, b + 300.0))
    gaps.sort()
    lo = dev_us(int((T0_S + PROFILED[0] * 0.05) * 1e9))
    hi = dev_us(int((T0_S + PROFILED[-1] * 0.05 + CALL_S) * 1e9))
    edges = [lo] + [x for g in gaps for x in g] + [hi]
    ops = [("k", a, b) for a, b in zip(edges[::2], edges[1::2])]
    device = tracing.DeviceTrace(ops=ops, spans=spans, launches=1,
                                 frames=len(PROFILED), window_s=0.1)
    win = Window(calls=calls, dropped=set(), window_s=0.51, t_first=T0_S,
                 poses=[], sample=[], retunes=1, memory_peak_bytes=0,
                 device=device, profiled=PROFILED)
    return RunData(cell=None, window=win, reference=None, frame={}), recs


@pytest.fixture
def program(monkeypatch):
    """The program's snapshot() replaced by the synthetic records."""
    from bibim_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "snapshot", lambda last=None: recs)

    return use


def _readers():
    cell = cells.load_cell("shaderball_1080p.orbit")
    assert NEW == tuple(m["name"] for m in cell.per_layer[-len(NEW):])
    return {name: cells.load_module(cell, "metrics", name).read
            for name in NEW}


def test_each_reader_on_a_synthetic_window(program):
    run, recs = _run()
    program(recs)
    got = {name: read(run) for name, read in _readers().items()}
    assert got["framegraph.geometry_ms"] == pytest.approx(2.0)
    assert got["framegraph.raster_ms"] == pytest.approx(4.0)
    assert got["framegraph.shade_ms"] == pytest.approx(3.0)
    assert got["framegraph.overlay_ms"] == pytest.approx(8.0)
    assert got["framegraph.output_ms"] == pytest.approx(0.5)
    # 1 in frame.shade + 1 under framegraph.frame; the one under
    # session.frame alone is outside the frame graph.
    assert got["framegraph.host_syncs"] == 2.0
    # Frame 3's 4 ms over the 6 calls kept (10 less the 4 profiled).
    assert got["autotune.ms_per_s"] == pytest.approx(4.0 / (6 * CALL_S))
    assert got["readback.sync_ms"] == pytest.approx(0.3)
    # Staged: 100 + 60 us a frame; in framegraph.frame: 50 us more; the
    # 200 us after it is outside.
    assert got["framegraph.idle_staged_pct"] == pytest.approx(
        100 * 160 / 210)
    assert got["readback.queue_ms"] == pytest.approx(0.5)
    # Device-idle ms a profiled frame by stage: 100 us in frame.raster,
    # 60 in frame.overlay, none in the other three.
    assert got["framegraph.raster_idle_ms"] == pytest.approx(0.1)
    assert got["framegraph.overlay_idle_ms"] == pytest.approx(0.06)
    for stage in ("geometry", "shade", "output"):
        assert got[f"framegraph.{stage}_idle_ms"] == 0.0
    # The 50 us a frame before frame.geometry is in no stage.
    idle = program_trace.idle_ms_by_stage(run)
    assert idle[None] == pytest.approx(len(PROFILED) * 0.05)
    assert sum(idle.values()) == pytest.approx(len(PROFILED) * 0.21)
    assert program_trace.span_median_ms(run, "framegraph.frame") == \
        pytest.approx(18.7)


def test_a_frame_outside_the_window_is_left_out(program):
    """Frames 4-7 are profiled; only frame 3 retunes. Let the call at
    frame 3's time dispatch frame 6 (a profiled frame id) instead, and
    the window reads no retune time."""
    run, recs = _run()
    swap = {3: 6, 6: 3}
    program([r._replace(frame=swap.get(r.frame, r.frame)) for r in recs])
    calls = run.window.calls
    for i in (3, 6):
        calls[i] = timeline.Call(calls[i].t0, calls[i].t1, swap[i], [])
    assert program_trace.retune_ms_per_s(run) == 0.0
    assert len(program_trace.load(run).frames) == FRAMES - len(PROFILED)


def test_offset_recovered_from_a_known_shift(program):
    run, recs = _run()
    program(recs)
    assert program_trace.clock_offset_us(run) == pytest.approx(
        SHIFT_US - LEAD_US)
    run, recs = _run(spread_us=40.0)
    program(recs)
    assert program_trace.clock_offset_us(run) == pytest.approx(
        SHIFT_US - LEAD_US + 20.0)
    # Differences spread over 50 us: the clocks count as not mapped.
    run, recs = _run(spread_us=80.0)
    program(recs)
    assert program_trace.clock_offset_us(run) is None
    assert program_trace.idle_staged_pct(run) is None
    assert program_trace.stage_idle_ms(run, "frame.raster") is None


def test_readers_read_none_without_a_recorder(program, monkeypatch):
    readers = _readers()
    run, _ = _run()
    program([])
    assert all(read(run) is None for read in readers.values())
    from bibim_tpu_torch.utils import profiling

    run, _ = _run()
    monkeypatch.delattr(profiling, "snapshot")
    assert all(read(run) is None for read in readers.values())
