"""The port's band-sharded frame with shadows + IBL and with band
compaction, against the JAX package's sharded frame and the port's
single-card frame (tests/test_pipeline.py TestShardedRendering's
stretch cases; the rest are in test_torch_sharded.py), and the sharded
dry run (``parallel.dryrun``, the counterpart of the JAX package's
``dryrun_multichip``) on a stand-in resource root."""

import numpy as np
import pytest

from bibim_tpu_torch.pipeline import RenderSettings
from tests import torch_port_cases as cases

W, H = cases.SHARD_W, cases.SHARD_H


@pytest.mark.parametrize("ibl_kind", ["tables", "analytic"])
def test_sharded_shadows_and_ibl_match_single(ibl_kind):
    """The shadow map built once from the full scene, IBL shaded within
    each band (the equirect tables and the analytic fits)."""
    from bibim_tpu.ops.ibl import make_ibl, make_ibl_sh
    from bibim_tpu_torch import interop

    inputs = cases.shard_inputs(light_dir=(0.3, -1, 0.5))
    jibl = make_ibl() if ibl_kind == "tables" else make_ibl_sh()
    kw = dict(width=W, height=H, xla_cap=256, enable_shadows=True,
              enable_ibl=True, shadow_size=128)
    want, got, single = cases.shard_frames(4, inputs, kw,
                                ibl=(jibl, interop.ibl(jibl, device="cpu")))
    cases.assert_image_bound(got, want)
    assert cases.differing_pixels(got, single) < 5e-4


def test_sharded_band_compaction_matches_single():
    """``live_tile_cap`` compacts each band's shading to its covered tiles
    (the cap scaled to a band, below the band's tile count)."""
    from bibim_tpu.ops import texture_quad as jtq
    from bibim_tpu_torch.parallel.tile_shard import _band_cap

    w2, h2 = 1024, 128
    maps = {
        "alb_r": np.full((4, 4, 1), 200, np.uint8),
        "alb_g": np.full((4, 4, 1), 120, np.uint8),
        "alb_b": np.full((4, 4, 1), 80, np.uint8),
        "roughness": np.full((4, 4, 1), 128, np.uint8),
        "ao": np.full((4, 4, 1), 255, np.uint8),
    }
    inputs = cases.shard_inputs(width=w2, height=h2,
                                mats=jtq.build_quad_tables(maps))
    kw = dict(width=w2, height=h2, xla_cap=256, live_tile_cap=40,
              outputs="image")
    s = RenderSettings(**kw)
    band_nt = s.tiles_x * (-(-h2 // 4) // s.tile_h)
    assert _band_cap(40, 4, band_nt) < band_nt
    want, got, single = cases.shard_frames(4, inputs, kw)
    cases.assert_image_bound(got, want)
    assert cases.differing_pixels(got, single) < 5e-4
    assert np.abs(got.astype(int) - single.astype(int)).max() <= 1


def test_dryrun_multichip(tmp_path):
    """Two bands on the CPU over the stand-in ShaderBall: the away frame
    tunes once, the front frame drops, probes again and renders whole
    (``dryrun_multichip`` raises otherwise); the front frame shows the
    scene."""
    from bibim_tpu_torch.parallel.dryrun import dryrun_multichip

    cases.cap_threads()
    with cases.standin_resources(tmp_path, with_jax=False):
        r, (away, front) = dryrun_multichip(2, device="cpu")
    assert r.retunes >= 2 and r.mesh.n_bands == 2
    assert away.shape == front.shape == (128, 960, 3)
    assert front.float().mean() > away.float().mean()
