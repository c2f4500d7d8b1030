"""K10 on K1's schedule (csrc/raster.cu ``raster_gw_kernel``), replayed as
tensor ops: each slot's window start taken per slot as ``win[s // group] +
lb_al[s]`` (the kernel's group-window addressing: no per-slot starts on
the host), its overflow-then-window sequence split into ``c`` parts as a
K1 cluster splits it (``tests/test_torch_raster_split.py split_scan``),
the parts merged by the lexicographic max of (key, index).

On the instanced test frame, where slot bases align down to 8 rows (prefix
rows of the previous tile) and a 64-row group window drops rows, the replay
must give ``raster_tiles_gw_plain`` bit for bit at every cluster size, and
the JAX package's group-window raster (``raster_fused_pallas(interpret=
True)`` with ``group_pair_cap``): triangle ids and BinDiag counts equal,
depth keys within K1's bound (XLA:CPU's FMA contraction, ROADMAP queue
3)."""

import pytest
import torch

from bibim_tpu.ops import fused as jfused
from bibim_tpu_torch.ops import fused
from tests import torch_port_cases as cases
from tests.test_torch_raster_split import split_scan

W, H, TH, TW, NT = cases.W, cases.H, cases.TILE_H, cases.TILE_W, cases.NT
ONE_PASS = dict(max_candidates=512, overflow_cap=64, span_cap=16,
                raster_tile_cap=NT)
# 64 rows: the window drops rows of its groups; 2048: it holds them all.
GCAPS = [64, 2048]


def gw_replay(c: int, min_part: int = 1):
    """raster_tiles_gw_plain with the kernel's addressing and split."""
    def raster_gw(rec, big_ids, n_big, pair_tri, ids, win, lb_al, cnt_k,
                  init_zkey, group, tiles_x, tile_h, tile_w,
                  out_fields=fused._OUT_FIELDS, max_count=None):
        slot = torch.arange(ids.shape[0], device=ids.device)
        starts = win[slot // group] + lb_al
        px, py = fused._pixel_centres(ids, tiles_x, tile_h, tile_w)
        key, tri = split_scan(rec, big_ids, n_big, pair_tri, starts, cnt_k,
                              init_zkey, px, py, c, min_part)
        return key, fused._resolve_plain(rec, tri, px, py, out_fields)
    return raster_gw


@pytest.fixture(scope="module")
def inst():
    cases.cap_threads()
    return cases.jax_pass_of(*cases.instanced_scene())


def _port(inst, **kw):
    _, _, psetup, prec = inst
    return fused.raster_fused(prec, psetup, W, H, tile_h=TH, tile_w=TW,
                              **ONE_PASS, **kw)


@pytest.fixture(scope="module")
def gw_calls(inst):
    """gcap → (the frame's K10 call (args, kwargs), its raster, the
    slots' prefix rows, the rows its window dropped). The slots' true
    window bases come from the default frame's K1 call, whose starts the
    group window rebases."""
    def capture(store, fn):
        def run(*a, **k):
            store.append((a, k))
            return fn(*a, **k)
        return run

    k1 = []
    _port(inst, raster=capture(k1, fused.raster_tiles_plain))
    starts, counts = k1[0][0][5], k1[0][0][6]
    out = {}
    for gcap in GCAPS:
        calls = []
        got = _port(inst, group_pair_cap=gcap,
                    raster_gw=capture(calls, fused.raster_tiles_gw_plain))
        (args, kw), = calls
        win, lb_al, group = args[5], args[6], args[9]
        lb = torch.clamp(starts - win.repeat_interleave(group), 0, gcap)
        assert torch.equal(lb - lb % 8, lb_al)
        kept = torch.minimum(torch.clamp(gcap - lb, min=0), counts)
        out[gcap] = ((args, kw), got, int((lb - lb_al).sum()),
                     int((counts - kept).sum()))
    return out


def test_case_has_prefix_rows_and_drops(gw_calls):
    """Both windows rescan prefix rows; only the 64-row one drops rows,
    and the frame's BinDiag counts them."""
    for gcap in GCAPS:
        (args, kw), got, prefix, dropped = gw_calls[gcap]
        assert prefix > 0 and args[9] > 1, gcap
        assert kw["max_count"] == gcap + 7
        assert dropped == int(got[2].dropped_cap)
        assert (dropped > 0) == (gcap == 64), (gcap, dropped)


@pytest.mark.parametrize("min_part", [1, fused.CLUSTER_MIN_PART])
@pytest.mark.parametrize("c", fused.CLUSTER_SIZES)
@pytest.mark.parametrize("gcap", GCAPS)
def test_replay_equals_plain(gw_calls, gcap, c, min_part):
    """The device-derived starts and the split scan give K10's plain
    version bit for bit (min_part 64 is the kernel's: the 64-row windows
    stay one or two parts)."""
    (args, kw), _, _, _ = gw_calls[gcap]
    want = fused.raster_tiles_gw_plain(*args, **kw)
    got = gw_replay(c, min_part)(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cnt = args[7]
    total = int(args[2][0]) + cnt
    part = torch.clamp((total + c - 1) // c, min=min_part)
    if c > 1 and min_part == 1:
        assert bool((((total + part - 1) // part) > 1).any())


@pytest.fixture(scope="module")
def jax_gw(inst):
    setup, rec, _, _ = inst
    return {gcap: jfused.raster_fused_pallas(
        rec, setup, W, H, tile_h=TH, tile_w=TW, interpret=True,
        group_pair_cap=gcap, **ONE_PASS) for gcap in GCAPS}


@pytest.mark.parametrize("c", fused.CLUSTER_SIZES)
@pytest.mark.parametrize("gcap", GCAPS)
def test_replay_frame_matches_pallas(inst, gw_calls, jax_gw, gcap, c):
    """raster_fused over the replay: the JAX group-window raster's
    triangle ids and dropped_cap, and the port's plain frame bit for
    bit."""
    got = _port(inst, group_pair_cap=gcap, raster_gw=gw_replay(c))
    cases.assert_raster_close(got, jax_gw[gcap])
    cases.assert_raster_equal(got, gw_calls[gcap][1])
