"""The port's span recorder (bibim_tpu_torch.utils.profiling): nesting,
frame ids, self time, the ring, the disabled recorder, counters by span;
a CPU Session frame's spans on the stand-in ShaderBall scene, a retune's
reason; and, on the card (marker ``cuda``), that ``host_syncs`` counts
every synchronising call torch's sync debug mode reports. The file
imports no JAX, so the card test also runs on a machine with PyTorch
alone:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_profiling.py -m cuda
"""

import warnings

import pytest
import torch

from bibim_tpu_torch.host.gui import UiState
from bibim_tpu_torch.host.session import Session
from bibim_tpu_torch.utils import profiling
from bibim_tpu_torch.utils.profiling import FRAME_STAGES, Recorder


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, advanced by hand (ns)."""
    now = [0]
    monkeypatch.setattr(profiling, "_now", lambda: now[0])
    return now


def test_spans_nest_with_parent_and_frame(clock):
    rec = Recorder(size=64)
    assert rec.next_frame() == 0
    with rec.stage_scope("outer"):
        clock[0] = 10
        with rec.stage_scope("inner", ("why",)):
            clock[0] = 30
        with rec.stage_scope("inner2"):
            clock[0] = 40
    assert rec.next_frame() == 1
    with rec.stage_scope("next"):
        clock[0] = 50
    outer, inner, inner2, nxt = rec.snapshot()
    assert [r.name for r in (outer, inner, inner2, nxt)] == [
        "outer", "inner", "inner2", "next"]
    assert outer.parent == -1 and nxt.parent == -1
    assert inner.parent == outer.seq and inner2.parent == outer.seq
    assert (outer.frame, inner.frame, inner2.frame, nxt.frame) == (0, 0, 0, 1)
    assert (outer.start_ns, outer.end_ns) == (0, 40)
    assert (inner.start_ns, inner.end_ns, inner.ms) == (10, 30, 20e-6)
    assert inner.detail == ("why",) and outer.detail is None
    assert all(r.count is None for r in (outer, inner, inner2, nxt))


def test_self_time_is_less_direct_children(clock):
    rec = Recorder(size=64)
    with rec.stage_scope("frame"):
        clock[0] = 100
        with rec.stage_scope("a"):
            clock[0] = 300
            with rec.stage_scope("a.deep"):
                clock[0] = 350
        clock[0] = 400
        with rec.stage_scope("b"):
            clock[0] = 450
        clock[0] = 1000
    own = profiling.self_ns(rec.snapshot())
    by_name = {r.name: own[r.seq] for r in rec.snapshot()}
    # frame 1000 less a (250) and b (50); a less a.deep (50).
    assert by_name == {"frame": 700, "a": 200, "a.deep": 50, "b": 50}


def test_ring_keeps_the_newest_and_does_not_grow():
    rec = Recorder(size=8)
    ring = rec._ring
    for i in range(20):
        with rec.stage_scope(f"s{i}"):
            pass
    assert rec._ring is ring and len(ring) == 8
    got = rec.snapshot()
    assert [r.name for r in got] == [f"s{i}" for i in range(12, 20)]
    assert [r.seq for r in got] == list(range(12, 20))
    assert [r.name for r in rec.snapshot(last=3)] == ["s17", "s18", "s19"]
    with pytest.raises(ValueError):
        Recorder(size=12)
    assert len(profiling.RECORDER._ring) >= 65536


def test_snapshot_last_reads_the_newest_seqs():
    rec = Recorder(size=16)
    for i in range(40):
        with rec.stage_scope(f"s{i}"):
            pass
    with rec.stage_scope("open"):
        rec.count("c", 3)
        # Issued: s0..s39, "open" (40), the count (41); "open" is left
        # out while it is open, and a slot of an older lap is never read
        # as a newer seq.
        got = rec.snapshot(last=4)
        assert [(r.seq, r.name) for r in got] == [
            (38, "s38"), (39, "s39"), (41, "c")]
        assert got[-1].parent == 40 and got[-1].count == 3
        # More than the ring holds: what its 16 slots hold (the count
        # took s25's slot; "open"'s and snapshot()'s seqs left s24's and
        # s26's).
        wide = rec.snapshot(last=100)
        assert [r.name for r in wide] == (
            ["s24"] + [f"s{i}" for i in range(26, 40)] + ["c"])
    assert rec.snapshot(last=1) == []  # the seq snapshot() took itself
    names = [r.name for r in rec.snapshot(last=6)]
    assert names[-2:] == ["open", "c"]


def test_disabled_records_nothing():
    rec = Recorder(size=16)
    rec.set_enabled(False)
    a, b = rec.stage_scope("x"), rec.stage_scope("y", ("d",))
    assert a is b  # one shared no-op
    with a:
        with b:
            rec.count("host_syncs")
    with pytest.raises(KeyError):
        with rec.stage_scope("z"):
            raise KeyError("through the no-op")
    assert rec.snapshot() == []
    rec.set_enabled(True)
    with pytest.raises(KeyError):
        with rec.stage_scope("raises"):
            raise KeyError("through a span")
    with rec.stage_scope("after"):
        pass
    raised, after = rec.snapshot()
    # The span that raised is recorded and closed: the next is no child.
    assert raised.name == "raises" and after.parent == -1


def test_counters_are_tagged_with_their_span(clock):
    rec = Recorder(size=64)
    for frame in range(3):
        rec.next_frame()
        with rec.stage_scope("session.frame"):
            rec.count("host_syncs")  # outside framegraph.frame
            with rec.stage_scope("framegraph.frame"):
                for stage in FRAME_STAGES:
                    with rec.stage_scope(stage):
                        clock[0] += 1_000_000 * (1 + FRAME_STAGES.index(
                            stage))
                        if stage == "frame.shade":
                            rec.count("host_syncs", 2 + frame)
                rec.count("host_syncs")
    records = rec.snapshot()
    counts = [r for r in records if r.count is not None]
    assert len(counts) == 9
    for r in counts:
        parent = next(p for p in records if p.seq == r.parent)
        assert parent.frame == r.frame
        assert parent.name in ("session.frame", "framegraph.frame",
                               "frame.shade")
        assert r.start_ns == r.end_ns
    got = profiling.stage_medians(records)
    # Under framegraph.frame: 2 + frame in frame.shade, 1 directly.
    assert got["host_syncs"] == 4
    assert got == {"geometry_ms": 1.0, "raster_ms": 2.0, "shade_ms": 3.0,
                   "overlay_ms": 4.0, "output_ms": 5.0, "host_syncs": 4}
    assert profiling.stage_medians(records, frames=1)["host_syncs"] == 5


# ---------------------------------------------------------------------------
# A Session's frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    # Imported here: on a machine where another package is named
    # ``tests``, the card test below still collects.
    from tests import torch_port_cases as cases

    cases.cap_threads()
    with cases.standin_resources(tmp_path_factory.mktemp("standin"),
                                 with_jax=False) as cfg:
        yield cfg


def _shaderball(depth: int, device: str = "cpu", width=256, height=144,
                instances: int = 1) -> Session:
    ui = UiState(scene="shaderball", enable_tone_mapping=True,
                 selected_material=1, num_instances=instances)
    return Session(width=width, height=height, ui=ui, readback_depth=depth,
                   device=device)


def _frame_records() -> list:
    """The records of this thread's newest frame id."""
    frame = profiling.RECORDER._thread.open.state[1]
    return [r for r in profiling.snapshot(last=4096) if r.frame == frame]


def _children(records, parent):
    return sorted((r for r in records
                   if r.parent == parent.seq and r.count is None),
                  key=lambda r: r.start_ns)


def test_session_frame_spans(standin):
    s = _shaderball(depth=2)
    frames = []
    for _ in range(2):
        s.render(1 / 60)
        frames.append(_frame_records())
    for i, records in enumerate(frames):
        (root,) = [r for r in records if r.name == "session.frame"]
        assert root.parent == -1
        kids = _children(records, root)
        names = [r.name for r in kids]
        assert names.count("framegraph.frame") == 1
        (fg,) = [r for r in kids if r.name == "framegraph.frame"]
        stages = _children(records, fg)
        assert [r.name for r in stages] == list(FRAME_STAGES)
        for a, b in zip(stages, stages[1:]):
            assert a.end_ns <= b.start_ns
        for r in [fg] + stages:
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
        assert fg.start_ns <= stages[0].start_ns
        assert stages[-1].end_ns <= fg.end_ns
        # The stages cover the frame graph but for its input checks and
        # the steps between them.
        covered = sum(r.end_ns - r.start_ns for r in stages)
        assert covered >= 0.9 * (fg.end_ns - fg.start_ns)
        # The readback queues every frame; frame 0 also binds the caps.
        assert "readback.queue" in names
        retunes = [r for r in kids if r.name == "session.retune"]
        if i == 0:
            (retune,) = retunes
            assert retune.detail == ("first_bind",)
            assert retune.end_ns <= fg.start_ns
        else:
            assert retunes == []
        assert all(r.frame == records[0].frame for r in records)
    assert frames[1][0].frame == frames[0][0].frame + 1
    s.flush()


@pytest.mark.parametrize("cap,field", [
    ("max_candidates", "dropped_cap"),
    ("pair_budget", "dropped_pairs"),
    ("live_tile_cap", "dropped_tiles"),
])
def test_forced_drop_retune_names_the_field(standin, cap, field):
    s = _shaderball(depth=1)
    s.render(1 / 60)
    s._tuned[s._tune_key()][cap] = 1
    n = len(s.retunes)
    s.render(1 / 60)
    assert len(s.retunes) == n + 1
    records = _frame_records()
    (retune,) = [r for r in records if r.name == "session.retune"]
    assert retune.detail == ("dropped", field)
    (root,) = [r for r in records if r.name == "session.frame"]
    assert retune.parent == root.seq


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("instances", [1, 64])
def test_host_syncs_count_every_sync(tmp_path, instances):
    """Under torch's sync debug mode, the warnings of one 1920×1080
    ``Session.render`` of each benchmark configuration (one ball, 64
    balls; 2048² stand-in maps), a frame that does not retune, equal the
    ``host_syncs`` it counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    import chip_smoke
    from bibim_tpu_torch.assets import asset_cache
    from bibim_tpu_torch.utils import config

    cfg = chip_smoke.write_standin_resources(tmp_path, seed=0,
                                             map_size=2048)
    old = config._active_root, asset_cache.CACHE_DIR
    try:
        config.init_resource_root(cfg)
        asset_cache.CACHE_DIR = tmp_path / ".asset_cache"
        s = _shaderball(depth=2, device="cuda", width=1920, height=1080,
                        instances=instances)
        # Warm up until two calls in a row retune no more: a frame that
        # dropped geometry is retuned for one call later.
        quiet = 0
        for _ in range(12):
            n = len(s.retunes)
            s.render(1 / 60)
            quiet = quiet + 1 if len(s.retunes) == n else 0
            if quiet == 2:
                break
        assert quiet == 2, s.retunes
        torch.cuda.synchronize()
        n = len(s.retunes)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                s.render(1 / 60)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        records = _frame_records()
        # A retune's probe reads its counts back; it is not the frame path.
        assert len(s.retunes) == n, s.retunes[n:]
        s.flush()
    finally:
        config._active_root, asset_cache.CACHE_DIR = old
    # One warning a synchronising call; torch also warns once a process,
    # on the first switch, that the mode is a prototype.
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    counted = sum(r.count for r in records if r.name == "host_syncs")
    sites = [f"{w.filename}:{w.lineno}" for w in syncs]
    assert counted == len(syncs) > 0, (counted, sites)
