"""K4's schedule (csrc/raster.cu ``overlay_kernel``) replayed as tensor ops:
a fixed grid of clusters deals the live slots of the compact tile list
round robin (cluster g takes slots g, g + G, ... below n_live), each slot's
candidate sequence (overflow list, then its window) is split into the
kernel's parts, each part keeps the lexicographic max of (masked depth key,
candidate index) from the initial key (index -1), the parts merge by the
same max, and where an overlay triangle wins its colour is written in
place at the slot's tile. That must give ``overlay_tiles_plain`` bit for
bit: with ties between candidates (every triangle twice, the copy in
another colour), overflow rows, n_live of 0 and n_live equal to the list's
length, a scene key plane that every winner ties, and a cleared key."""

import numpy as np
import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.ops.raster import triangle_setup_planar as j_setup_planar
from bibim_tpu_torch.ops import fused
from tests import torch_port_cases as cases
from tests.test_torch_raster_split import split_scan

NPX = cases.TILE_H * cases.TILE_W


def overlay_replay(args, csize: int, clusters: int,
                   min_part: int = fused.OVERLAY_MIN_PART):
    """K4 on ``args`` (overlay_tiles' positional arguments) under the
    kernel's schedule with ``clusters`` clusters of ``csize`` blocks;
    returns (a new (3, NT, NPX) tensor, the slots each cluster took)."""
    (rec, big_ids, n_big, pair_tri, ids, starts, counts, n_live, zkey, ldr,
     tiles_x, tile_h, tile_w) = args
    out = ldr.clone()
    n = min(int(n_live[0]), ids.shape[0])
    dealt = [list(range(g, n, clusters)) for g in range(clusters)]
    slots = torch.tensor(sorted(s for d in dealt for s in d),
                         dtype=torch.int64)
    if slots.numel() == 0:
        return out, dealt
    tid = ids[slots].long()
    init = (zkey[tid] if zkey is not None
            else torch.zeros((slots.numel(), tile_h * tile_w),
                             dtype=torch.int32))
    px, py = fused._pixel_centres(ids[slots], tiles_x, tile_h, tile_w)
    _, tri = split_scan(rec, big_ids, n_big, pair_tri, starts[slots],
                        counts[slots], init, px, py, csize, min_part)
    r = fused._winner_channels(rec, tri)
    hit = r(fused._ID) >= 0.5
    e, inv = fused._bary(r, px, py)
    b = [e[j] * inv for j in range(3)]
    for c in range(3):
        base = fused._COL + 3 * c
        col = r(base) * b[0] + r(base + 1) * b[1] + r(base + 2) * b[2]
        out[c, tid] = torch.where(hit, col, out[c, tid])
    return out, dealt


@pytest.fixture(scope="module")
def scene():
    """The test frame as overlay geometry: JAX records with a seeded
    colour per triangle, the planar setup, and the frame's own keys."""
    cases.cap_threads()
    jscene, view, proj = cases.jax_scene()
    soup = j_assemble(jscene.batches, view, proj)
    jsetup = j_setup_planar(soup.clip, cases.W, cases.H)
    rec = cases.record_table(jfused.build_record_table_planar(jsetup, soup))
    rng = np.random.default_rng(11)
    col = torch.as_tensor(rng.uniform(0, 1, (rec.shape[0], 9)),
                          dtype=torch.float32)
    rec[:, fused._COL:fused._COL + 9] = col
    setup = cases.planar_setup(jsetup)
    _, zkey, _ = fused.raster_fused(rec, setup, cases.W, cases.H,
                                    max_candidates=2048, overflow_cap=512,
                                    span_cap=128)
    return rec, setup, zkey


def _duplicated(rec, setup):
    """Every triangle twice, the copy in the next colour: each win between
    the two is a tie that the later copy (higher id) must take."""
    rec2 = rec.clone()
    rec2[:, fused._COL:fused._COL + 9] = torch.roll(
        rec[:, fused._COL:fused._COL + 9], 1, dims=1)
    cat = torch.cat
    return cat([rec, rec2]).contiguous(), setup._replace(
        edge_a=tuple(cat([a, a]) for a in setup.edge_a),
        edge_b=tuple(cat([a, a]) for a in setup.edge_b),
        edge_c=tuple(cat([a, a]) for a in setup.edge_c),
        z_coef=tuple(cat([a, a]) for a in setup.z_coef),
        w_coef=tuple(cat([a, a]) for a in setup.w_coef),
        bbox=tuple(cat([a, a]) for a in setup.bbox),
        valid=cat([setup.valid, setup.valid]),
        zub=None if setup.zub is None else cat([setup.zub, setup.zub]))


def _k4_args(rec, setup, zkey, max_tiles, span_cap):
    """overlay_tiles' arguments as composite_overlay makes them (its
    overlay argument captures them)."""
    got = []

    def capture(*args, **kw):
        got.append(args)
        return args[9]

    rng = np.random.default_rng(3)
    ldr = torch.as_tensor(rng.uniform(0, 1, (3, cases.NT, NPX)),
                          dtype=torch.float32)
    fused.composite_overlay(rec, setup, ldr, zkey, cases.W, cases.H,
                            max_candidates=2048, overflow_cap=512,
                            span_cap=span_cap, max_tiles=max_tiles,
                            overlay=capture)
    return got[0]


CASES = {
    # kind: (scene keys?, duplicated?, max_tiles, span_cap, n_live)
    "scene_keys": (True, False, cases.NT, 128, None),
    "cleared_key": (False, False, cases.NT, 128, None),
    "overflow_rows": (True, False, cases.NT, 8, None),
    "ties": (False, True, cases.NT, 8, None),
    "n_live_0": (True, False, cases.NT, 8, 0),
    "n_live_full": (False, False, "live", 8, None),
}


_MADE: dict = {}


def _case(scene, kind):
    """(rec, K4's arguments, the plain version's result) of a case."""
    if kind not in _MADE:
        keys, dup, max_tiles, span_cap, n_live = CASES[kind]
        rec, setup, zkey = scene
        if dup:
            rec, setup = _duplicated(rec, setup)
        if max_tiles == "live":
            args = _k4_args(rec, setup, None, cases.NT, span_cap)
            max_tiles = int(args[7][0])
        args = _k4_args(rec, setup, zkey if keys else None, max_tiles,
                        span_cap)
        if n_live is not None:
            args = args[:7] + (torch.tensor([n_live], dtype=torch.int32),) \
                + args[8:]
        _MADE[kind] = rec, args, fused.overlay_tiles_plain(*args)
    return _MADE[kind]


@pytest.mark.parametrize("min_part", [fused.OVERLAY_MIN_PART, 2])
@pytest.mark.parametrize("csize,clusters", [(1, 1), (2, 3), (8, 5),
                                             (8, 64)])
@pytest.mark.parametrize("kind", list(CASES))
def test_schedule_equals_plain(scene, kind, csize, clusters, min_part):
    """min_part: the kernel's (8), and 2, so that every window of the test
    frame (up to ~150 candidates) splits as far as the cluster allows."""
    rec, args, want = _case(scene, kind)
    n = int(args[7][0])
    nb = int(args[2][0])
    got, dealt = overlay_replay(args, csize, clusters, min_part)
    assert torch.equal(got, want)
    # Every live slot once, none past n_live.
    assert sorted(s for d in dealt for s in d) == list(range(n))
    changed = (want != args[9]).any(dim=0)
    if kind == "n_live_0":
        assert n == 0 and not changed.any()
        return
    assert changed.any(dim=1).sum() > 1
    if kind == "n_live_full":  # the list holds exactly the live tiles
        assert n == args[4].shape[0] < cases.NT
    if kind in ("overflow_rows", "ties"):
        assert nb > 0
    if kind == "scene_keys":
        # The overlay is the scene itself on its own keys: every covered
        # pixel's winner ties the initial key and replaces the pixel.
        assert changed.float().mean() > 0.3
    if kind == "ties":
        # The later copy of each pair wins: the winners' colours are the
        # copies' (rolled) colours, never the originals'.
        t = rec.shape[0] // 2
        px, py = fused._pixel_centres(args[4][:n], args[10], args[11],
                                      args[12])
        _, tri = fused._scan_plain(rec, args[1], args[2], args[3],
                                   args[5][:n], args[6][:n],
                                   torch.zeros((n, NPX), dtype=torch.int32),
                                   px, py)
        hit = tri >= 0
        assert bool((tri[hit] >= t).all())
    total = nb + args[6][:n].to(torch.int64)
    part = torch.clamp((total + csize - 1) // csize, min=min_part)
    parts = (total + part - 1) // part
    if csize == 8:  # some slots split, some leave parts empty
        assert bool((parts > 1).any()) and bool((parts < csize).any())
