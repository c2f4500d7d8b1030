"""The harness's data-driven loading, camera paths and end-to-end
arithmetic, on the CPU."""

import json
import re

import numpy as np
import pytest

from h100_bench import camera_paths, cells, check, harness, timeline
from h100_bench.tests.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads(workload):
    cell = cells.load_cell(workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        mod = cells.load_module(cell, "metrics", m["name"])
        assert callable(mod.read)
    params = camera_paths.merged_params(cell.traffic["path"], cell.config)
    assert camera_paths.warmup_poses(params)
    assert set(cell.config["limits"]) == set(check.NAMES)
    # The configuration says where its scene is; the mix, how the camera
    # moves.
    assert set(cell.config["camera"]) <= set(camera_paths.SCENE_KEYS)
    assert not set(cell.config["camera"]) & set(cell.traffic["path"])


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    metrics = b["end_to_end"] + b["per_layer"]
    for entry in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", ()):
            assert any(x["name"] == w for x in b["workloads"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_new_cell_is_new_files_only(tmp_path):
    """A throwaway configuration, mix, metric and plain reference in a
    directory of their own load into a cell beside the benchmark's
    files."""
    b = bench()
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "reference").mkdir()
    cfg = json.loads((BENCH / "configs" / "shaderball_1080p.json").read_text())
    cfg.update(name="extra_720p", width=1280, height=720,
               reference="extra_ref")
    (tmp_path / "reference" / "extra_ref.py").write_text(
        "FAULTS = {'dark': {'exposure': 0.0}}\n\n\n"
        "class Ref:\n"
        "    def __init__(self, *args):\n"
        "        self.args = args\n\n\n"
        "def make(config, root, device, dtype):\n"
        "    return Ref(config, root, device, dtype)\n")
    (tmp_path / "configs" / "extra_720p.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "orbit.json").read_text())
    mix["path"]["yaw_rate_deg"] = [0.5, 1.0]
    (tmp_path / "traffic" / "slow_orbit.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "extra.frames.py").write_text(
        "def read(run):\n    return float(run.window.retunes)\n")
    b["workloads"].append({"name": "extra_720p.slow_orbit",
                           "config": "extra_720p", "traffic": "slow_orbit",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "extra.frames", "unit": "count",
                           "better": "lower", "source": "program_counter",
                           "layer": "host.session",
                           "moves": "frame_device_ms",
                           "workloads": ["extra_720p.slow_orbit"]})
    (tmp_path / "B.json").write_text(json.dumps(b))
    cell = cells.load_cell("extra_720p.slow_orbit", tmp_path / "B.json",
                           (tmp_path, BENCH))
    assert cell.config["width"] == 1280
    assert cell.traffic["path"]["yaw_rate_deg"] == [0.5, 1.0]
    names = [m["name"] for m in cell.per_layer]
    assert "extra.frames" in names and "k1.roofline_pct" not in names
    # Every cell reports the device ms a frame; a metric with a
    # ``workloads`` list only the cells it names.
    assert "frame_device_ms" in [m["name"] for m in cell.end_to_end]

    class Win:
        retunes = 3

    class Run:
        window = Win()

    assert cells.load_module(cell, "metrics", "extra.frames").read(Run()) == 3
    # The reference the configuration names is the one the harness
    # builds, and its faults the ones a control plants.
    ref = harness.make_reference(cell.config, tmp_path, "cpu",
                                 dirs=cell.dirs)
    assert type(ref).__module__ == "h100_bench_reference_extra_ref"
    assert ref.args[0]["name"] == "extra_720p" and ref.args[1:3] == (
        tmp_path, "cpu")
    assert harness.reference_module(cell.config, cell.dirs).FAULTS == {
        "dark": {"exposure": 0.0}}


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_a_configuration_without_the_key_gets_render(workload):
    """No ``"reference"`` key: ``reference/render.py``, its ShaderBall
    reference, its facts and its three overlay faults."""
    import torch

    cell = cells.load_cell(workload)
    assert "reference" not in cell.config
    mod = harness.reference_module(cell.config, cell.dirs)
    assert mod.__file__ == str(BENCH / "reference" / "render.py")
    assert mod.FAULTS == {"overlays": {"show_lights": False,
                                       "show_gizmo": False},
                          "gizmo": {"show_gizmo": False},
                          "spheres": {"show_lights": False}}
    root = harness.prepare_resources(cell.config, 2**31 + 3)
    ref = harness.make_reference(cell.config, root, "cpu", dirs=cell.dirs)
    assert isinstance(ref, mod.Reference) and ref.dt == torch.float32
    assert (ref.inp.width, ref.inp.num_instances) == (
        cell.config["width"], cell.config["num_instances"])
    assert ref.facts() == {"lights": 3, "map_sizes": {
        "albedo": (2048, 2048), "metallic": (16, 16),
        "roughness": (2048, 2048), "ao": (16, 16)}}


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_camera_path_is_the_seeds(workload):
    cell = cells.load_cell(workload)
    params = camera_paths.merged_params(cell.traffic["path"], cell.config)
    big = 2**31 + 7

    def poses(seed, n=400):
        p = camera_paths.CameraPath(params, seed)
        return [p.pose(i) for i in range(n)]

    a, b, c = poses(big), poses(big), poses(big + 1)
    assert a == b
    assert a != c
    # Redrawn every segment: the path's parameters change inside 400
    # frames of 6-frame segments.
    if params["kind"] == "orbit":
        radii = {round(sum((x - y) ** 2 for x, y in zip(p[0],
                                                        params["centre"]))
                       ** 0.5, 4) for p in a}
        assert len(radii) >= 3
        lo, hi = params["radius"]
        assert all(lo - 1e-4 <= r <= hi + 1e-4 for r in radii)
    else:
        (x0, x1), (z0, z1) = params["box"]
        assert all(x0 <= p[0][0] <= x1 and z0 <= p[0][2] <= z1 for p in a)
        heights = {round(p[0][1] - params["plane_y"], 6) for p in a}
        assert len(heights) >= 3


def test_orbit_turns_one_way_with_a_path_sense():
    params = {"kind": "orbit", "dt": 1 / 60, "segment_s": 0.2, "strata": 6,
              "sense": "path", "centre": [0.0, 0.0, 0.0],
              "radius": [5.0, 7.0], "pitch_deg": [-30.0, -8.0],
              "yaw_rate_deg": [3.0, 9.0]}
    for seed in range(5):
        path = camera_paths.CameraPath(params, 2**31 + seed)
        yaws = np.unwrap(np.radians([path.pose(i)[1] for i in range(200)]))
        steps = np.degrees(np.diff(yaws))
        # One sense the whole path, each step a drawn rate: no cut.
        assert (np.all(steps > 2.9) or np.all(steps < -2.9)), seed
        assert np.all(np.abs(steps) < 9.1)


def test_configuration_cannot_set_the_mix():
    path = json.loads((BENCH / "traffic" / "orbit.json").read_text())["path"]
    with pytest.raises(ValueError):
        camera_paths.merged_params(path, {"camera": {"segment_s": 0.25}})
    with pytest.raises(ValueError):
        camera_paths.merged_params(dict(path, radius=[1.0, 2.0]),
                                   {"camera": {"radius": [5.0, 7.0]}})


def test_end_to_end_arithmetic():
    """Depth-2 loop: call i dispatches frame i and hands back frame i-1;
    the drain hands back the last. 300 frames of 10 ms calls, frame 7
    dropped geometry, frame 40 took a 500 ms call."""
    calls, t = [], 0.0
    for i in range(300):
        dt = 0.5 if i == 41 else 0.01
        calls.append(timeline.Call(t, t + dt, i, [i - 1] if i else []))
        t += dt
    calls.append(timeline.Call(t, t + 0.005, None, [299]))
    window = t + 0.005
    s = timeline.summarize(calls, {7}, window)
    assert s["attempted"] == 300 and s["returned"] == 300
    assert s["failed"] == 1
    assert s["frames_per_s"] == pytest.approx(300 / window)
    # Frame i's latency spans calls i and i + 1: 20 ms, except frames 40
    # and 41 (510 ms) and the last (15 ms).
    lat = s["latency_ms"]
    assert lat[40] == pytest.approx(510) and lat[41] == pytest.approx(510)
    assert lat[299] == pytest.approx(15)
    assert s["frame_p95_ms"] == pytest.approx(20)
    # A frame that never came back is failed and leaves no tail.
    s = timeline.summarize(calls[:-1], set(), window)
    assert s["failed"] == 1 and s["frame_p95_ms"] is None
    assert timeline.nearest_rank(range(1, 101), 0.95) == 95


def test_device_busy_is_the_union_of_device_ops():
    """Overlapping device ops count once, gaps not at all; host-side
    events and annotations are no device work."""
    from torch.autograd import DeviceType

    from h100_bench import tracing

    class Ev:
        def __init__(self, a, b, dev=DeviceType.CUDA, note=False):
            self.a, self.b, self.dev, self.note = a, b, dev, note

        def start_ns(self):
            return self.a

        def end_ns(self):
            return self.b

        def device_type(self):
            return self.dev

        def is_user_annotation(self):
            return self.note

    events = [Ev(50, 60), Ev(0, 10), Ev(5, 20), Ev(20, 30), Ev(52, 55),
              Ev(100, 400, DeviceType.CPU), Ev(0, 1000, note=True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    # [0, 30] and [50, 60].
    assert tracing.device_busy_s(Prof()) == pytest.approx(40e-9)
    events[:] = []
    assert tracing.device_busy_s(Prof()) == 0.0

