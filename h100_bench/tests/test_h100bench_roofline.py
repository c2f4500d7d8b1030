"""The kernel counts against hand-worked bytes and operations, at small
shapes (a 256 × 16 frame: K2's live tiles are two 8 × 128 tile rows of
two tiles)."""

import pytest
import torch

from h100_bench import peaks
from h100_bench.roofline import k1, k2

W, H = 256, 16


def k1_case():
    # Triangle 0: bbox x 0-9, y 0-3 (40 pixels); triangle 1: x 120-130,
    # y 6-9 (44 pixels, across four 8 × 128 tiles); triangle 2 culled.
    bbox = (torch.tensor([0, 120, 0]), torch.tensor([0, 6, 0]),
            torch.tensor([9, 130, 255]), torch.tensor([3, 9, 15]))
    tri = torch.full((H * W,), -1)
    tri[:10] = 0  # row 0, x 0-9
    tri[9 * W + 129] = 1
    tri[9 * W + 130] = 1
    setup = {"valid": torch.tensor([True, True, False]), "bbox": bbox}
    passes = {"main": dict(setup=setup, tri=tri, width=W, height=H)}
    # Coverage floats of 2 candidates, records of 2 winners, the id
    # plane of every pixel, 9 more planes at 12 covered pixels.
    nbytes = (2 * 15 * 4 + 2 * 40 * 4 + W * H * 4 + 12 * 9 * 4)
    ops = (40 + 44) * 25 + 12 * 100
    return k1, passes, {}, nbytes, ops


def k2_case():
    u = torch.zeros(H * W)
    v = torch.zeros(H * W)
    tri = torch.full((H * W,), -1)
    # Two pixels at uv (0.5, 0.5): on a 4 × 4 map texels x, y in {1, 2};
    # one at (0, 0): x, y in {3, 0} (wrapped). All in tile (0, 0).
    tri[[0, 1, 2]] = 0
    u[[0, 1]] = 0.5
    v[[0, 1]] = 0.5
    passes = {"main": dict(tri=tri, u=u, v=v, width=W, height=H)}
    frame = {"lights": 3, "map_sizes": {k: (4, 4) for k in
                                        ("albedo", "roughness", "metallic",
                                         "ao")}}
    nbytes = 1024 + 3 * 8 * 4 + 8 * 6 + 3 * 16 * 4 + 1024 * 3 * 4
    ops = 3 * (3 * 80 + 4 * 6 * 8)
    return k2, passes, frame, nbytes, ops


@pytest.mark.parametrize("case", [k1_case, k2_case], ids=["k1", "k2"])
def test_kernel_count(case):
    mod, passes, frame, nbytes, ops = case()
    assert mod.count(passes, frame) == (nbytes, ops)
    t = peaks.bound_s(nbytes, ops)
    assert t == max(nbytes / 3.35e12, ops / 67e12)
