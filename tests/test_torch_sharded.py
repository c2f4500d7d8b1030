"""The port's band-sharded frame (``bibim_tpu_torch.parallel``) on bands
on the CPU, case for case against tests/test_pipeline.py
TestShardedRendering.

Each case renders the JAX package's sharded frame (on the test process's
virtual CPU devices) and the port's from the same numpy inputs and holds
them to the golden bound; it also holds the port's sharded frame against
the port's own single-card frame at the JAX test's rule: equal where the
JAX test asserts equality, 5e-4 of pixels (and 1 LSB) where it allows
that. On the CPU the JAX package's bands take its XLA fallback raster,
which sets up each band from ``viewport`` instead of rebased records, so
the two sharded frames are two formulations of the same frame.

Also here: the two forms of the mesh — bands in one process and one band
per ``torch.distributed`` rank (two gloo ranks on the CPU) — give the same
image bit for bit.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from bibim_tpu.parallel import make_device_mesh as jax_mesh
from bibim_tpu.parallel import render_frame_sharded as jax_sharded
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch.parallel import make_device_mesh, render_frame_sharded
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from tests import torch_port_cases as cases

W, H = cases.SHARD_W, cases.SHARD_H


@pytest.fixture(scope="module")
def sphere():
    return cases.shard_inputs()


@pytest.fixture(scope="module")
def overlay():
    return cases.shard_overlay()


def test_sharded_matches_single(sphere):
    want, got, single = cases.shard_frames(4, sphere, dict(width=W, height=H,
                                                xla_cap=256))
    cases.assert_image_bound(got, want)
    np.testing.assert_array_equal(got, single)


def test_sharded_with_overlays_matches_single(sphere, overlay):
    """Light spheres and the gizmo on 8 bands (8-row bands: the 32² gizmo
    spans four of them)."""
    want, got, single = cases.shard_frames(8, sphere, dict(width=W, height=H,
                                                xla_cap=256,
                                                gizmo_extent=32), overlay)
    cases.assert_image_bound(got, want)
    assert cases.differing_pixels(got, single) < 5e-4


def test_sharded_pair_sampling_matches_single():
    """Pair sampling at level 2 with exact routing on block tables, 8
    bands: equal to the single-card frame at pair level 0 (pair groups
    never straddle a band seam: bands are whole tiles)."""
    from bibim_tpu.ops import texture_quad as jtq

    def flat(val):
        return np.full((256, 256, 1), val, np.uint8)

    rng = np.random.default_rng(5)
    maps = {
        "alb_r": rng.integers(0, 256, (256, 256, 1), np.uint8),
        "alb_g": flat(90), "alb_b": flat(60),
        "nrm_x": flat(128), "nrm_y": flat(128), "nrm_z": flat(255),
        "metallic": flat(10),
        "roughness": rng.integers(0, 256, (256, 256, 1), np.uint8),
        "ao": flat(255), "height": flat(0),
    }
    mats = jtq.build_quad_tables(maps, block_threshold=1024)
    assert any(isinstance(t, jtq.BlockTable) for t in mats)
    inputs = cases.shard_inputs(mats=mats)
    kw = dict(width=W, height=H, xla_cap=256, pair_sampling=2,
              sample_route_caps=(32, 32))
    want, got, _ = cases.shard_frames(8, inputs, kw)
    exact_kw = dict(kw, pair_sampling=0, outputs="image")
    exact = render_frame(*inputs[1], None,
                         RenderSettings(**exact_kw))["image"].numpy()
    exact_bands = render_frame_sharded(make_device_mesh(8, device="cpu"),
                                       *inputs[1],
                                       RenderSettings(**exact_kw)).numpy()
    cases.assert_image_bound(got, want)
    np.testing.assert_array_equal(got, exact_bands)
    np.testing.assert_array_equal(got, exact)


def test_sharded_forward_matches_single(sphere):
    want, got, single = cases.shard_frames(4, sphere, dict(width=W, height=H,
                                                deferred=False,
                                                xla_cap=256))
    cases.assert_image_bound(got, want)
    np.testing.assert_array_equal(got, single)


def test_sharded_overflow_reports_drops(sphere):
    """A pair budget far below the sphere's live pairs: the summed drop
    counts raise, and ``return_diag`` returns them (as the JAX package
    does)."""
    kw = dict(width=W, height=H, xla_cap=256, pair_budget=8)
    mesh = make_device_mesh(4, device="cpu")
    pin = sphere[1]
    with pytest.raises(AssertionError, match="pair"):
        render_frame_sharded(mesh, *pin, RenderSettings(**kw))
    img, diag = render_frame_sharded(mesh, *pin, RenderSettings(**kw),
                                     check=False, return_diag=True)
    assert int(diag.dropped_pairs) > 0
    assert img.shape == (H, W, 3)
    _, jdiag = jax_sharded(jax_mesh(4), *sphere[0],
                           jfg.RenderSettings(**kw), check=False,
                           return_diag=True)
    assert int(jdiag.dropped_pairs) > 0


def test_sharded_pads_non_divisible_heights(sphere):
    """56 rows over 4 bands: 16-row bands, the last one cropped to 8."""
    kw = dict(width=W, height=H - 8, xla_cap=256)
    jin, pin = sphere
    want = np.asarray(jax_sharded(jax_mesh(4), *jin,
                                  jfg.RenderSettings(**kw)))
    got = render_frame_sharded(make_device_mesh(4, device="cpu"), *pin,
                               RenderSettings(**kw)).numpy()
    # The camera's aspect stays the 128×64 frame's in both renders.
    single = render_frame(*pin, None, RenderSettings(
        **dict(kw, outputs="image")))["image"].numpy()
    assert got.shape == (H - 8, W, 3)
    cases.assert_image_bound(got, want)
    np.testing.assert_array_equal(got, single)


def test_mesh_defaults():
    """The mesh's two forms: bands in one process (the CPU here; on the
    card band k on cuda:(k % cards)) and, from a distributed environment,
    one band per rank."""
    mesh = make_device_mesh(3, device="cpu")
    assert mesh.n_bands == 3 and mesh.local_bands == (0, 1, 2)
    assert mesh.group is None and set(mesh.ranks) == {0}
    assert make_device_mesh(device="cpu").n_bands == 1


# ---------------------------------------------------------------------------
# One band per rank: two gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _rank_main(rank: int, init: str, out_dir: str, pin, pov) -> None:
    """A rank of the two-rank frame (``pin``, ``pov``: the port's inputs
    and overlay resources): its image and drop counts saved as .npy."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from bibim_tpu_torch.parallel import make_process_mesh

    torch.set_num_threads(1)
    mesh = make_process_mesh(device="cpu", init_method=init)
    try:
        img, diag = render_frame_sharded(
            mesh, *pin, RenderSettings(width=W, height=H, gizmo_extent=32),
            overlay=pov, return_diag=True)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), img.numpy())
        np.save(os.path.join(out_dir, f"diag{rank}.npy"),
                np.array([int(v) for v in diag]))
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_equal_in_process_bands(sphere, overlay, tmp_path):
    """Two spawned ranks over gloo, one band each: every rank's image is
    ``torch.equal`` to the in-process 2-band frame (the same band function
    on the same inputs), drop-free."""
    init = f"file://{tmp_path / 'rendezvous'}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, init, str(tmp_path),
                                                  sphere[1], overlay[1]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not alive, f"ranks {alive} did not finish in 120 s"
    assert [p.exitcode for p in procs] == [0, 0]
    want = render_frame_sharded(
        make_device_mesh(2, device="cpu"), *sphere[1],
        RenderSettings(width=W, height=H, gizmo_extent=32),
        overlay=overlay[1])
    for r in range(2):
        got = torch.from_numpy(np.load(tmp_path / f"rank{r}.npy"))
        assert torch.equal(got, want), r
        assert not np.load(tmp_path / f"diag{r}.npy").any()
