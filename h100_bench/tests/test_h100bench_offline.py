"""BASELINE config 5's cell (``shaderball_4k_shadow_ibl.offline_orbit``):
its loading, the ``offline`` driver through ``run_cell`` on the CPU at a
small size, the six readers it adds on synthetic records and a synthetic
profile (K1's launches put down to the ``shade.shadow_map`` span they
fell in), and the K5 and light-pass counts against hand arithmetic."""

import dataclasses
import time

import pytest
import torch

from h100_bench import cells, harness, span_reads, timeline, tracing
from h100_bench.drivers import offline
from h100_bench.drivers.viewer import Window
from h100_bench.harness import RunData
from h100_bench.roofline import k5, shadow
from h100_bench.tests.conftest import small_cell

CELL = "shaderball_4k_shadow_ibl.offline_orbit"
NEW = ("framegraph.shadow_map_ms", "framegraph.pcf_ms", "framegraph.ibl_ms",
       "framegraph.shadow_launches", "k5.roofline_pct",
       "shadow.roofline_pct")


def test_the_cell_loads():
    cell = cells.load_cell(CELL)
    cfg = cell.config
    assert (cfg["width"], cfg["height"]) == (3840, 2160)
    assert cfg["reference"] == "shadow_ibl" and cfg["shadows"] and cfg["ibl"]
    assert (cfg["shadow_size"], cfg["shadow_bias"], cfg["shadow_light"]) \
        == (1024, 0.002, 0)
    assert cell.traffic["driver"] == "offline" and cell.chips == 1
    names = [m["name"] for m in cell.per_layer]
    assert names[-len(NEW):] == list(NEW)
    assert "k1.roofline_pct" not in names and "k2.roofline_pct" not in names
    for name in NEW:
        assert callable(cells.load_module(cell, "metrics", name).read)
    assert harness.reference_module(cfg, cell.dirs).__file__.endswith(
        "reference/shadow_ibl.py")
    # The new metrics are read in this cell alone.
    for other in ("shaderball_1080p.closeup", "shaderball64_1080p.orbit_row"):
        got = {m["name"] for m in cells.load_cell(other).per_layer}
        assert not got & set(NEW)


def test_offline_driver_runs_the_cell_on_the_cpu(tmp_path):
    """256 × 144 on the CPU (the kernels' plain versions): the session
    draws the light pass, PCF and IBL, the frames it hands back match the
    shadow / IBL reference, and the program's readers read its spans."""
    cell = small_cell(tmp_path, "shaderball_4k_shadow_ibl", "offline_orbit",
                      256, 144, check_frames=2)
    logs = []
    result, checks = harness.run_cell(cell, 2**31 + 5, 0.5, True, "cpu",
                                      time.perf_counter(), logs.append)
    assert result["correct"] and result["failed"] == 0, checks
    m = result["metrics"]
    for name in ("framegraph.shadow_map_ms", "framegraph.pcf_ms",
                 "framegraph.ibl_ms"):
        assert m[name]["value"] > 0
    assert m["framegraph.shadow_launches"]["value"] >= 2  # a sort, a pass
    # No device, so no device trace to read.
    assert "k5.roofline_pct" not in m and "shadow.roofline_pct" not in m


def test_a_program_without_the_toggles_is_refused(monkeypatch):
    """Where ``UiState`` lacks ``enable_shadows`` / ``enable_ibl`` the
    session is refused as it is made, before any frame."""
    from bibim_tpu_torch.host import gui

    cell = cells.load_cell(CELL)
    fields = [(f.name, f.type, f) for f in dataclasses.fields(gui.UiState)
              if f.name not in ("enable_shadows", "enable_ibl")]
    monkeypatch.setattr(gui, "UiState", dataclasses.make_dataclass(
        "UiState", fields))
    with pytest.raises(TypeError):
        offline.make_session(cell.config, cell.traffic, "cpu")


def test_kernel_launches_pair_by_correlation_id():
    from torch.autograd import DeviceType

    class Range:
        def __init__(self, a, b):
            self.start, self.end = a, b

    class Ev:
        def __init__(self, name, dev, id_, a, b):
            self.name, self.device_type, self.id = name, dev, id_
            self.time_range = Range(a, b)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Ev("cudaLaunchKernel", cpu, 7, 10.0, 12.0),
              Ev("aten::add", cpu, 3, 9.0, 13.0),
              Ev("void bb::raster_kernel<4>", cuda, 7, 15.0, 20.0),
              Ev("cudaLaunchKernelExC", cpu, 8, 30.0, 31.0),
              Ev("cudaMemcpyAsync", cpu, 9, 31.5, 32.0),
              Ev("Memcpy DtoH", cuda, 9, 32.0, 33.0),
              Ev("void bb::raster_kernel<4>", cuda, 8, 40.0, 50.0),
              Ev("cudaLaunchCooperativeKernel", cpu, 11, 51.0, 52.0),
              Ev("void bb::sort_onesweep<int>", cuda, 11, 53.0, 54.0)]

    class Prof:
        @staticmethod
        def events():
            return events

    assert offline.kernel_launches(Prof()) == [
        (10.0, "void bb::raster_kernel<4>", 15.0, 20.0, "cudaLaunchKernel"),
        (30.0, "void bb::raster_kernel<4>", 40.0, 50.0,
         "cudaLaunchKernelExC"),
        (51.0, "void bb::sort_onesweep<int>", 53.0, 54.0,
         "cudaLaunchCooperativeKernel")]


# -- the readers on a synthetic window ---------------------------------------

FRAMES = 10
PROFILED = range(4, 8)
SHIFT_US = 2_000_000.0  # profiler us less program us
T0_S = 500.0
CALL_S = 0.04
MS = 1_000_000
# Inside frame.shade, in turn: shade.shadow_map (3 ms, two launches
# counted), shade.pcf (0.5 ms), shade.ibl (1 ms; frame 3 a second one of
# 0.5 ms).
SHADE = (("shade.shadow_map", 3.0), ("shade.pcf", 0.5), ("shade.ibl", 1.0))


def _records(counter=True, spans=True):
    from bibim_tpu_torch.utils.profiling import Record

    out, seq = [], [0]

    def add(name, a, b, parent, frame, count=None):
        s = seq[0]
        seq[0] += 1
        out.append(Record(s, name, int(a), int(b), parent, frame, None,
                          count))
        return s

    starts = {}
    for f in range(FRAMES):
        t = int((T0_S + f * 0.05) * 1e9)
        root = add("session.frame", t + MS, t + int(CALL_S * 1e9) - MS, -1,
                   f)
        fg = add("framegraph.frame", t + 2 * MS, t + 30 * MS, root, f)
        sh = add("frame.shade", t + 10 * MS, t + 20 * MS, fg, f)
        c = t + 11 * MS
        for name, ms in SHADE + ((("shade.ibl", 0.5),) if f == 3 else ()):
            if spans:
                s = add(name, c, c + int(ms * MS), sh, f)
                if name == "shade.shadow_map":
                    starts[f] = c
                    if counter:
                        add("shadow_launches", c + 1, c + 1, s, f, count=1)
                        add("shadow_launches", c + 2, c + 2, s, f, count=1)
            c += int(ms * MS)
    return out, starts


def _run(launches=True, **kw):
    recs, starts = _records(**kw)
    calls = [timeline.Call(T0_S + f * 0.05, T0_S + f * 0.05 + CALL_S, f,
                           [f - 1] if f else []) for f in range(FRAMES)]
    fg = {r.frame: r for r in recs if r.name == "framegraph.frame"}
    spans = [("render_frame", fg[f].start_ns / 1e3 + SHIFT_US,
              fg[f].end_ns / 1e3 + SHIFT_US, 1) for f in PROFILED]
    # Each profiled frame: a K1 launch 1 ms into shade.shadow_map (100 us
    # on the device), a K1 launch 1 ms before it (300 us) and a K5 launch
    # after it (200 us).
    kept, ops = [], []
    for f in PROFILED:
        at = (starts.get(f, fg[f].start_ns + 9 * MS)) / 1e3 + SHIFT_US
        for k, (dt, name, us) in enumerate(
                ((1000.0, "void bb::raster_kernel<4>", 100.0),
                 (-1000.0, "void bb::raster_kernel<4>", 300.0),
                 (4000.0, "void bb::gbuffer_shade_kernel", 200.0))):
            a = at + dt + 50.0
            kept.append((at + dt, name, a, a + us, "cudaLaunchKernel"))
            ops.append((name, a, a + us))
    device = tracing.DeviceTrace(ops=ops, spans=spans, launches=len(kept),
                                 frames=len(PROFILED), window_s=0.2)
    win = Window(calls=calls, dropped=set(), window_s=0.5, t_first=T0_S,
                 poses=[], sample=[], retunes=0, memory_peak_bytes=0,
                 device=device, profiled=PROFILED)
    if launches:
        win.launches = kept
    return RunData(cell=None, window=win, reference=None, frame={},
                   _rooflines={"k5": 4e-4, "shadow": 2e-4}), recs


@pytest.fixture
def program(monkeypatch):
    from bibim_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "snapshot", lambda last=None: recs)

    return use


def _readers():
    cell = cells.load_cell(CELL)
    return {n: cells.load_module(cell, "metrics", n).read for n in NEW}


def test_each_new_reader_on_a_synthetic_window(program):
    run, recs = _run()
    program(recs)
    got = {name: read(run) for name, read in _readers().items()}
    assert got["framegraph.shadow_map_ms"] == pytest.approx(3.0)
    assert got["framegraph.pcf_ms"] == pytest.approx(0.5)
    # Window frames 0-3, 8, 9: frame 3 spends 1.5 ms, the others 1 ms.
    assert got["framegraph.ibl_ms"] == pytest.approx(1.0)
    assert got["framegraph.shadow_launches"] == 2.0
    # K5: 4 × 200 us against a 0.4 ms bound.
    assert got["k5.roofline_pct"] == pytest.approx(50.0)
    # Only the K1 launch inside shade.shadow_map counts: 4 × 100 us
    # against 0.2 ms.
    assert span_reads.kernel_s_in_span(run, "K1", "shade.shadow_map") == \
        pytest.approx(4e-4)
    assert got["shadow.roofline_pct"] == pytest.approx(50.0)


def test_new_readers_read_none_where_the_program_has_nothing(program):
    readers = _readers()
    # No spans and no counter (a program without them); no launches kept.
    run, recs = _run(launches=False, spans=False)
    program(recs)
    assert all(readers[n](run) is None for n in NEW if n != "k5.roofline_pct")
    # Spans but no counter: the counter reads None, not 0.
    run, recs = _run(counter=False)
    program(recs)
    assert readers["framegraph.shadow_launches"](run) is None
    assert readers["framegraph.shadow_map_ms"](run) == pytest.approx(3.0)
    # No device trace at all.
    run, recs = _run()
    run.window.device = None
    program(recs)
    assert readers["k5.roofline_pct"](run) is None
    assert readers["shadow.roofline_pct"](run) is None


# -- the counts ---------------------------------------------------------------

def test_k5_count():
    """A 4 × 4 main pass with 5 covered pixels, 3 lights: with a light
    pass, 12 G-buffer + 1 visibility + 3 ambient + 3 LDR planes a covered
    pixel; without, no visibility plane."""
    tri = torch.full((16,), -1)
    tri[[0, 3, 5, 6, 15]] = 2
    passes = {"main": dict(tri=tri, width=4, height=4)}
    frame = {"lights": 3}
    assert k5.count(passes, frame) == (5 * 18 * 4 + 3 * 16 * 4, 5 * 3 * 80)
    passes["shadow"] = {}
    assert k5.count(passes, frame) == (5 * 19 * 4 + 3 * 16 * 4, 5 * 3 * 80)


def test_shadow_count():
    """A 16 × 16 light pass: triangle 0's box x 0-3, y 0-1 (8 texels),
    triangle 1's x 2-9, y 4-8 (40 texels), triangle 2 culled; 6 texels
    covered by 2 winners."""
    bbox = (torch.tensor([0, 2, 0]), torch.tensor([0, 4, 0]),
            torch.tensor([3, 9, 15]), torch.tensor([1, 8, 15]))
    tri = torch.full((256,), -1)
    tri[[0, 1, 2]] = 0
    tri[[70, 71, 86]] = 1
    setup = {"valid": torch.tensor([True, True, False]), "bbox": bbox}
    passes = {"main": {}, "shadow": dict(setup=setup, tri=tri, width=16,
                                         height=16)}
    nbytes = 2 * 15 * 4 + 2 * 16 * 4 + 256 * 4 + 6 * 2 * 4
    ops = (8 + 40) * 25 + 6 * 100
    assert shadow.count(passes, {}) == (nbytes, ops)
