"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU at a small size (its look for a card left
out), with ``Session.render`` faulted as a later change could fault it;
and the sound run comes out correct. At the cells' own size, 1920 × 1080,
the comparison fails the frames of the reference put in the program's
place with the overlays left out or one block altered."""

import time

import numpy as np
import pytest
import torch

from bibim_tpu_torch.host.session import Session
from h100_bench import cells, check, harness
from h100_bench.tests.conftest import small_cell

SEED = 2**31 + 5


def stale(render):
    """A step that returns its state unchanged: every frame the first."""
    first = []

    def f(self, *a, **k):
        img = render(self, *a, **k)
        if img is not None and not first:
            first.append(img.copy())
        return first[0] if img is not None else None
    return f


def previous(render):
    """Each image handed back one call late: the frame of the pose
    before."""
    last = []

    def f(self, *a, **k):
        img = render(self, *a, **k)
        if img is None:
            return None
        out = last[-1] if last else img
        last[:] = [img.copy()]
        return out
    return f


def altered(render):
    """An answer altered where it is produced: a 16 × 16 block of every
    frame inverted."""
    def f(self, *a, **k):
        img = render(self, *a, **k)
        if img is not None:
            img = img.copy()
            img[8:24, 8:24] = 255 - img[8:24, 8:24]
        return img
    return f


def half(render):
    """Half of the batch left out: the lower half of every frame's rows
    never written."""
    def f(self, *a, **k):
        img = render(self, *a, **k)
        if img is not None:
            img = img.copy()
            img[img.shape[0] // 2:] = 0
        return img
    return f


FAULTS = {"sound": None, "stale": stale, "previous": previous,
          "altered": altered, "half": half}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_fails_correct(tmp_path, monkeypatch, fault):
    # The close-up pan: the plane's two triangles keep the plain raster
    # fast on the CPU, and the magnified maps move under every frame.
    cell = small_cell(tmp_path, "shaderball_1080p", "closeup", 256, 144,
                      check_frames=3)
    if FAULTS[fault] is not None:
        monkeypatch.setattr(Session, "render", FAULTS[fault](Session.render))
    result, checks = harness.run_cell(cell, SEED, 6.0, False, "cpu",
                                      time.perf_counter(), log=lambda m: 0)
    assert result["attempted"] >= 4
    assert checks["frames_compared"]["value"] >= 3
    assert result["correct"] is (fault == "sound"), checks
    # The device ms a frame needs a device trace, which the CPU has not.
    assert set(result["metrics"]) == {"setup_s"}
    assert np.isfinite(result["metrics"]["setup_s"]["value"])


# (cell, pose): the ball with its three light spheres in view; the
# 64-ball row broadside from 62 units.
FULL_SIZE = {"shaderball_1080p": ("shaderball_1080p.closeup",
                                  ((3.0, 1.0, -3.0), 40.0, -20.0)),
             "shaderball64_1080p": ("shaderball64_1080p.orbit_row",
                                    ((63.0, 15.047, -57.888), 0.0, -15.0))}
# What the frame handed back leaves out, as configuration settings: the
# faults the cell's reference module plants (FAULTS), besides the sound
# frame and a block inverted.
PLANTED = {c: harness.reference_module(cells.load_cell(name).config).FAULTS
           for c, (name, _) in FULL_SIZE.items()}
DROPPED = {c: {"sound": {}, **faults, "block": {}}
           for c, faults in PLANTED.items()}


# From 62 units the 64-ball view shows its three spheres at a dozen
# pixels: its frames hold the gizmo, the spheres only as far as the
# frame-wide numbers reach, so that pair is not a case.
FULL_SIZE_CASES = [(c, f) for c in FULL_SIZE for f in DROPPED[c]
                   if (c, f) != ("shaderball64_1080p", "spheres")]


@pytest.mark.parametrize("config,fault", FULL_SIZE_CASES)
def test_fault_fails_correct_at_full_size(config, fault):
    name, pose = FULL_SIZE[config]
    cell = cells.load_cell(name)
    root = harness.prepare_resources(cell.config, SEED)
    ref = harness.make_reference(cell.config, root, "cpu")
    with torch.no_grad():
        want, overlay = harness.reference_frame(ref, pose)
        got = harness.reference_frame(harness.make_reference(
            dict(cell.config, **DROPPED[config][fault]), root, "cpu"),
            pose)[0]
    if fault == "block":  # 16 × 16 pixels, 0.012 % of the frame
        got[540:556, 960:976] = 255 - got[540:556, 960:976]
    read = check.readings(lambda p: (want, overlay), [(got, pose)])
    correct, checks = check.verdict(read, cell.config["limits"])
    assert correct is (fault == "sound"), checks
    if fault != "sound":
        # The frame-wide share alone would let it pass.
        assert read["bad_px_pct"] <= cell.config["limits"]["bad_px_pct"]


def _without_spheres(composite):
    """The light spheres composited into a copy that is thrown away."""
    def f(ldr, *a, **k):
        copy = (ldr.clone() if isinstance(ldr, torch.Tensor)
                else tuple(c.clone() for c in ldr))
        return ldr, composite(copy, *a, **k)[1]
    return f


@pytest.mark.cuda
def test_program_without_overlays_fails_on_the_card(tmp_path, monkeypatch,
                                                     cuda_device):
    """The program's own frame at 1920 × 1080 with its light spheres and
    gizmo left out, through the whole run: not correct."""
    from bibim_tpu_torch.pipeline import framegraph

    cell = small_cell(tmp_path, "shaderball_1080p", "orbit", 1920, 1080,
                      check_frames=4)
    monkeypatch.setattr(framegraph, "_composite_light_spheres",
                        _without_spheres(framegraph._composite_light_spheres))
    monkeypatch.setattr(framegraph, "_gizmo_into",
                        lambda img, *a, **k: img)
    result, checks = harness.run_cell(cell, SEED, 3.0, False, cuda_device,
                                      time.perf_counter(), log=lambda m: 0)
    assert checks["frames_compared"]["value"] >= 3
    assert result["correct"] is False, checks
    assert checks["overlay_bad_pct"]["value"] > 50, checks
