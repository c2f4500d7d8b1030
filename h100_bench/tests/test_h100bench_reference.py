"""The plain reference against the program's all-plain frame (the
``Session`` on the CPU, where every kernel runs its plain version) on the
same stand-in inputs, one pose of each configuration at a small size; and
the bfloat16 control, which must fail the configuration's limits."""

import numpy as np
import pytest
import torch

from h100_bench import check, harness
from h100_bench.drivers import viewer
from h100_bench.tests.conftest import small_cell

# (config, pose, width, height): the ball and both light spheres from
# above; the 64-ball row broadside from 62 units, every ball in view.
CASES = [
    ("shaderball_1080p", ((3.0, 1.0, -3.0), 40.0, -20.0), 256, 144),
    ("shaderball64_1080p", ((63.0, 15.047, -57.888), 0.0, -15.0), 256, 144),
]
SEED = 2**31 + 11


def render_pair(cell, pose, device, dtype=torch.float32):
    root = harness.prepare_resources(cell.config, SEED)
    session = viewer.make_session(cell.config, cell.traffic, device)
    viewer.set_pose(session, pose)
    session.render()
    session.flush()  # the tune at this pose
    session.render()
    got = session.flush()[-1]
    ref = harness.make_reference(cell.config, root, device)
    want = ref.render(*pose).cpu().numpy()
    low = harness.make_reference(cell.config, root, device, dtype)
    return got, want, low.render(*pose).cpu().numpy()


@pytest.mark.parametrize("config,pose,width,height", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_matches_plain_frame(tmp_path, config, pose, width,
                                       height):
    cell = small_cell(tmp_path, config, "orbit", width, height)
    got, want, low = render_pair(cell, pose, "cpu", torch.bfloat16)
    limits = cell.config["limits"]
    r = check.frame_readings(got, want)
    assert (got.max(-1) > 0).mean() > 0.05  # something was drawn
    assert all(r[k] <= limits[k] for k in limits), r
    if cell.config["num_instances"] == 1:
        # One ball: the plain kernels and the reference round alike.
        assert np.array_equal(got, want)
    c = check.frame_readings(low, want)
    assert any(c[k] > limits[k] for k in limits), c


@pytest.mark.cuda
def test_reference_matches_kernels_on_the_card(tmp_path, cuda_device):
    config, pose, width, height = CASES[0]
    cell = small_cell(tmp_path, config, "orbit", 1920, 1080)
    got, want, low = render_pair(cell, pose, cuda_device, torch.bfloat16)
    limits = cell.config["limits"]
    r = check.frame_readings(got, want)
    assert all(r[k] <= limits[k] for k in limits), r
    c = check.frame_readings(low, want)
    assert any(c[k] > limits[k] for k in limits), c
