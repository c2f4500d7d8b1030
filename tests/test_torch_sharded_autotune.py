"""The band machinery under the port's sharded frame against the JAX
package on the CPU: the rebased record table, the band triangle setup
(planar and (T, 3)), the band probes and ``autotune_settings_sharded``
field for field, and ``ShardedRenderer`` (tests/test_pipeline.py's
autotuned band caps and the camera that swings onto the scene), whose
band settings must equal the JAX renderer's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.ops.raster import triangle_setup as j_setup
from bibim_tpu.ops.raster import triangle_setup_planar as j_setup_planar
from bibim_tpu.parallel import ShardedRenderer as JaxRenderer
from bibim_tpu.parallel import make_device_mesh as jax_mesh
from bibim_tpu.pipeline import autotune as jat
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops.raster import triangle_setup, triangle_setup_planar
from bibim_tpu_torch.parallel import ShardedRenderer, make_device_mesh
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.pipeline import autotune as pat
from tests import torch_port_cases as cases

W, H = cases.SHARD_W, cases.SHARD_H
# Band origins of the setup cases: 16-row bands of the 256×128 test
# frame (the first, an inner one, the last) and a band below the frame.
BANDS = ((0, 16), (48, 16), (112, 16), (128, 16))


def _settings_dict(s):
    return {f.name: (int(v) if f.name == "gbuffer_viz" else v)
            for f in dataclasses.fields(s)
            for v in (getattr(s, f.name),)}


@pytest.fixture(scope="module")
def jax_pass():
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    soup = j_assemble(scene.batches, view, proj)
    setup = j_setup_planar(soup.clip, cases.W, cases.H)
    return soup, jfused.build_record_table_planar(setup, soup)


@pytest.mark.parametrize("y0", [8, 40, 1072])
def test_shift_record_table_matches_jax(jax_pass, y0):
    """C += B·y0 on the edges and on the z / w planes' constants, every
    other channel untouched: the port rounds the product and the sum
    apart (bit-equal to numpy doing so); XLA:CPU may fuse them into an
    FMA, so the JAX package's rows are within an ulp of the product."""
    _, jrec = jax_pass
    rec = cases.record_table(jrec)
    got = fused.shift_record_table_y(rec, y0).numpy()
    want = cases.record_table(jfused.shift_record_table_y(
        jrec, jnp.float32(y0))).numpy()
    r = rec.numpy()
    consts = [fused._C + e for e in range(3)] + [fused._ZC + 2,
                                                  fused._WC + 2]
    slopes = [fused._B + e for e in range(3)] + [fused._ZC + 1,
                                                  fused._WC + 1]
    rest = [c for c in range(fused._USED) if c not in consts]
    np.testing.assert_array_equal(got[:, rest], r[:, rest])
    np.testing.assert_array_equal(want[:, rest], r[:, rest])
    prod = r[:, slopes] * np.float32(y0)
    np.testing.assert_array_equal(got[:, consts], r[:, consts] + prod)
    assert (np.abs(got[:, consts] - want[:, consts])
            <= np.spacing(np.abs(prod))).all()
    assert not got[:, fused._USED:].any()


@pytest.mark.parametrize("y0,band_h", BANDS)
def test_band_setup_matches_jax(jax_pass, y0, band_h):
    """The band's planar setup from the JAX clip planes: culling and
    bounding boxes (band rows) bit-equal, coefficients in frame
    coordinates as the full frame's."""
    soup, _ = jax_pass
    want = j_setup_planar(soup.clip, cases.W, cases.H,
                          band_y0=jnp.float32(y0), band_height=band_h)
    clip = tuple(tuple(cases.t(c) for c in k) for k in soup.clip)
    got = triangle_setup_planar(clip, cases.W, cases.H, band_y0=y0,
                                band_height=band_h)
    full = triangle_setup_planar(clip, cases.W, cases.H)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for a, b in zip(got.bbox, want.bbox):
        np.testing.assert_array_equal(a.numpy()[valid], np.asarray(b)[valid])
    assert (got.bbox[1].numpy() <= got.bbox[3].numpy())[valid].all()
    assert (got.bbox[3].numpy() < band_h).all()
    for name in ("edge_a", "edge_b", "edge_c", "z_coef", "w_coef"):
        for a, b, c in zip(getattr(got, name), getattr(want, name),
                           getattr(full, name)):
            np.testing.assert_array_equal(a.numpy(), c.numpy())
            np.testing.assert_allclose(a.numpy()[valid],
                                       np.asarray(b)[valid], rtol=2e-5,
                                       atol=2e-6)
    if y0 >= cases.H:
        assert not valid.any()


@pytest.mark.parametrize("y0,band_h", BANDS)
def test_band_indexed_setup_matches_jax(jax_pass, y0, band_h):
    """The (T, 3) setup of the same triangles in a band (their corners as
    (3T, 4) clip rows, ``sequential``): culling and bounding boxes
    bit-equal to the JAX package's and to the planar band setup's."""
    soup, _ = jax_pass
    corners = [np.stack([np.asarray(soup.clip[k][c]) for k in range(4)],
                        axis=-1) for c in range(3)]
    clip = np.stack(corners, axis=1).reshape(-1, 4)
    tris = np.arange(clip.shape[0], dtype=np.int32).reshape(-1, 3)
    js = j_setup(jnp.asarray(clip), jnp.asarray(tris), cases.W, cases.H,
                 band_y0=jnp.float32(y0), band_height=band_h,
                 sequential=True)
    got = triangle_setup(cases.t(clip), cases.t(tris), cases.W, cases.H,
                         band_y0=y0, band_height=band_h, sequential=True)
    planar = triangle_setup_planar(
        tuple(tuple(cases.t(c) for c in k) for k in soup.clip), cases.W,
        cases.H, band_y0=y0, band_height=band_h)
    valid = np.asarray(js.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(planar.valid.numpy(), valid)
    for k in range(4):
        np.testing.assert_array_equal(got.bbox[k].numpy()[valid],
                                      np.asarray(js.bbox[:, k])[valid])
        np.testing.assert_array_equal(got.bbox[k].numpy(),
                                      planar.bbox[k].numpy())


@pytest.fixture(scope="module")
def sphere():
    return cases.shard_inputs()


@pytest.mark.parametrize("n", [2, 4])
def test_probe_band_caps_match_jax(sphere, n):
    """Worst-band demands, every band probed with its band setup: the JAX
    package's CapProbe field for field on tests/test_pipeline.py's
    sphere."""
    (jscene, jvb), (pscene, pvb) = sphere[0][:2], sphere[1][:2]
    kw = dict(width=W, height=H)
    want = jat.probe_band_caps(jscene, jvb, jfg.RenderSettings(**kw), n)
    got = pat.probe_band_caps(pscene, pvb, RenderSettings(**kw), n)
    assert got._asdict() == want._asdict()
    assert got.n_tiles == RenderSettings(**kw).tiles_x * (
        pat.band_height(RenderSettings(**kw), n) // 8)
    assert got.max_candidates > 0 and got.escape_tiles == -1


def _band_pass0_live(scene, vb, settings, n: int) -> int:
    """The most pass-0 live tiles of any band, as the band's main pass
    counts them (``ops.fused.raster_fused`` with a one-slot
    ``raster_tile_cap`` drops all live tiles but one)."""
    from bibim_tpu_torch.pipeline.framegraph import _main_setup

    band_h = pat.band_height(settings, n)
    worst = 0
    for b in range(n):
        soup, setup = _main_setup(scene, vb, settings,
                                  band=(band_h, b * band_h))
        rec = fused.build_record_table_planar(setup, soup)
        _, _, diag = fused.raster_fused(
            rec, setup, settings.width, band_h, max_candidates=2048,
            overflow_cap=1024, span_cap=settings.span_cap,
            pair_budget=1 << 20, raster_tile_cap=1, band_y0=b * band_h)
        assert not (int(diag.dropped_cap) or int(diag.dropped_overflow))
        worst = max(worst, int(diag.dropped_tiles) + 1)
    return worst


@pytest.mark.parametrize("span_cap", [4, 8])
def test_probe_band_caps_cover_overflow_in_band_rows(span_cap):
    """The test scene's 100× ground plane routes triangles to the overflow
    list that cover the lower band. The port tests their cover over the
    band's own tiles, so its bin-live (and covered) tiles are the band
    raster's own pass-0 live tiles; the JAX package tests the frame's
    first rows instead and counts fewer (measured on 2 bands of the
    256×128 frame: 15 / 14 tiles against 16 at span_cap 4 / 8). Every
    other field is the JAX package's."""
    n = 2
    from bibim_tpu_torch import interop

    scene, view, proj = cases.jax_scene()
    vb = jfg.ViewBlock(view=view, proj=proj, view_pos=jnp.zeros(3),
                       enable_normal_map=jnp.int32(0))
    pscene = interop.scene_data(scene, device="cpu")
    pvb = interop.view_block(vb, device="cpu")
    kw = dict(width=cases.W, height=cases.H, span_cap=span_cap)
    want = jat.probe_band_caps(scene, vb, jfg.RenderSettings(**kw), n)
    got = pat.probe_band_caps(pscene, pvb, RenderSettings(**kw), n)
    live = _band_pass0_live(pscene, pvb, RenderSettings(**kw), n)
    assert got.bin_tiles == got.covered_tiles == live
    assert want.bin_tiles < live
    differ = ("bin_tiles", "covered_tiles")
    assert ({k: v for k, v in got._asdict().items() if k not in differ}
            == {k: v for k, v in want._asdict().items() if k not in differ})


def test_autotune_settings_sharded_matches_jax():
    """``autotune_settings_sharded(pair_sampling=2, margin=1.05,
    materials=, overlay=)`` as chip_smoke.py's sharded phase calls it, on
    tests/test_pipeline.py's sphere with block tables (the escape probe
    decides the routing), light spheres and the gizmo stand-in: frame
    settings, band settings and band probe the JAX package's, field for
    field."""
    from bibim_tpu.ops import texture_quad as jtq

    mats = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    jin, pin = cases.shard_inputs(mats=mats)
    jov, pov = cases.shard_overlay()
    kw = dict(width=W, height=H, gizmo_extent=32, pair_sampling=2,
              outputs="image")
    want = jat.autotune_settings_sharded(
        jin[0], jin[1], jfg.RenderSettings(**kw), n_bands=4, margin=1.05,
        overlay=jov, materials=jin[3])
    got = pat.autotune_settings_sharded(
        pin[0], pin[1], RenderSettings(**kw), n_bands=4, margin=1.05,
        overlay=pov, materials=pin[3])
    assert _settings_dict(got[0]) == _settings_dict(want[0])
    assert _settings_dict(got[1]) == _settings_dict(want[1])
    assert got[2]._asdict() == want[2]._asdict()
    assert got[1].pair_budget >= got[2].total_pairs


def test_sharded_autotuned_band_caps_match_single(sphere):
    """ShardedRenderer on 4 bands: one tune, the JAX renderer's band
    settings, drop-free, equal to the single-card frame."""
    (jin, pin), kw = sphere, dict(width=W, height=H, xla_cap=256)
    jr = JaxRenderer(jax_mesh(4), jfg.RenderSettings(**kw), jin[3])
    want = np.asarray(jr.render(*jin[:3]))
    r = ShardedRenderer(make_device_mesh(4, device="cpu"),
                        RenderSettings(**kw), pin[3])
    got = r.render(*pin[:3]).numpy()
    assert r.retunes == jr.retunes == 1
    assert _settings_dict(r._band) == _settings_dict(jr._band)
    assert r._band.max_candidates < RenderSettings().max_candidates
    single = render_frame(*pin, None, RenderSettings(
        **dict(kw, outputs="image")))["image"].numpy()
    cases.assert_image_bound(got, want)
    np.testing.assert_array_equal(got, single)


def test_sharded_skew_camera_recovers():
    """Caps probed with the scene behind the camera (floor buckets) drop
    geometry once the camera swings onto a dense sphere: the renderer
    probes again (retunes 2), its merged caps the JAX renderer's, and the
    frame equals the single-card frame."""
    from bibim_tpu.scene import FreeLookCamera

    away = FreeLookCamera()
    away.apply_mouse_drag(300, 0)
    kw = dict(width=W, height=H, xla_cap=256)
    (jaway, paway) = cases.shard_inputs(segments=(32, 24), cam=away)
    (jfront, pfront) = cases.shard_inputs(segments=(32, 24))
    jr = JaxRenderer(jax_mesh(8), jfg.RenderSettings(**kw), jaway[3],
                     margin=1.05)
    r = ShardedRenderer(make_device_mesh(8, device="cpu"),
                        RenderSettings(**kw), paway[3], margin=1.05)
    jr.render(*jaway[:3])
    r.render(*paway[:3])
    assert r.retunes == 1 and r._band.max_candidates == 64
    want = np.asarray(jr.render(*jfront[:3]))
    got = r.render(*pfront[:3]).numpy()
    assert r.retunes == jr.retunes == 2
    assert _settings_dict(r._band) == _settings_dict(jr._band)
    assert _settings_dict(r._frame) == _settings_dict(jr._frame)
    single = render_frame(*pfront, None, RenderSettings(
        **dict(kw, outputs="image")))["image"].numpy()
    cases.assert_image_bound(got, want)
    np.testing.assert_array_equal(got, single)
