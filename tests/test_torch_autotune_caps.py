"""The rest of the port's capacity autotune against the JAX package on the
CPU: the escape-tile probe that decides pair-sampling routing, the
light-sphere and gizmo overlay caps, the shadow pass's light-view probe,
``grow_caps`` and ``autotune_settings`` with all of them, on the
instanced test frame and a small config-5-like frame (shadows fit to the
ball, light spheres, a corner gizmo)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.pipeline import autotune as jat
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch.pipeline import autotune as pat
from bibim_tpu_torch.pipeline import RenderSettings
from tests import torch_port_cases as cases

# A config-5-like frame at the test size: shadows fit to the ball, light
# spheres, the gizmo stand-in (cases.frame_inputs).
C5 = dict(cases.FRAME_BASE, span_cap=32, outputs="image",
          enable_shadows=True, shadow_size=256, shadow_fit_batches=(0,))
INSTANCED = dict(cases.INSTANCED_BASE, span_cap=64, outputs="image")


def _settings_dict(s):
    return {f.name: (int(v) if f.name == "gbuffer_viz" else v)
            for f in dataclasses.fields(s)
            for v in (getattr(s, f.name),)}


@pytest.fixture(scope="module")
def frames():
    """name → (JAX (scene, view block, materials, overlay), the same in
    the port, settings keywords)."""
    cases.cap_threads()
    jin, pin = cases.frame_inputs()
    out = {"config5": ((jin[0], jin[1], jin[3], jin[4]),
                       (pin[0], pin[1], pin[3], pin[4]), C5)}
    scene, view, proj = cases.instanced_scene()
    vb = jfg.ViewBlock(view=view, proj=proj, view_pos=jnp.zeros(3),
                       enable_normal_map=jnp.int32(0))
    mats = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    out["instanced"] = (
        (scene, vb, mats, None),
        (interop.scene_data(scene, device="cpu"),
         interop.view_block(vb, device="cpu"),
         interop.material_tables(mats, device="cpu"), None), INSTANCED)
    return out


@pytest.mark.parametrize("name", ["config5", "instanced"])
@pytest.mark.parametrize("pair", [1, 2], ids=["pairs", "quads"])
def test_probe_escape_tiles_match_jax(frames, name, pair):
    """The probe's escape tiles (the block tables' (h, w) at a pair level)
    and covered tiles equal the JAX package's."""
    (jscene, jvb, jmats, _), (pscene, pvb, _, _), kw = frames[name]
    shapes = tuple((t.height, t.width) for t in jmats
                   if isinstance(t, jtq.BlockTable))
    want = jat.probe_frame_caps(jscene, jvb, jfg.RenderSettings(**kw),
                                esc_probe=(pair, shapes))
    got = pat.probe_frame_caps(pscene, pvb, RenderSettings(**kw),
                               esc_probe=(pair, shapes))
    assert got.covered_tiles == want.covered_tiles
    assert got.escape_tiles == want.escape_tiles
    assert 0 < got.escape_tiles <= got.covered_tiles
    assert pat.probe_frame_caps(pscene, pvb, RenderSettings(**kw),
                                measure_coverage=False).escape_tiles == -1


@pytest.mark.parametrize("dx", [0.0, 40.0, 400.0],
                         ids=["in_view", "edge", "outside"])
def test_overlay_tiles_match_jax(dx):
    """The projected bound of the light-sphere composite's tiles, with
    the lights in view, shifted to the edge and out of it; a light behind
    the camera bounds it by the whole screen."""
    from bibim_tpu.scene.shaderball import shaderball_lights

    scene, view, proj = cases.jax_scene()
    pos = np.asarray(shaderball_lights().pos) + np.float32([dx, 0, 0])
    for p in (pos, np.concatenate([pos, [[0.0, 0.0, -5.0]]])):
        p = p.astype(np.float32)
        for margin in (1.05, 1.5):
            kw = dict(width=cases.W, height=cases.H)
            want = jat.derive_overlay_tiles(p, view, proj,
                                            jfg.RenderSettings(**kw),
                                            margin=margin)
            got = pat.derive_overlay_tiles(cases.t(p), cases.t(view),
                                           cases.t(proj),
                                           RenderSettings(**kw),
                                           margin=margin)
            assert got == want
    assert got == cases.NT  # the light behind the camera


@pytest.mark.parametrize("extra", [dict(), dict(show_gizmo=False),
                                   dict(show_lights=False)],
                         ids=["spheres_and_gizmo", "spheres", "gizmo"])
def test_overlay_caps_match_jax(frames, extra):
    (jscene, jvb, _, jov), (pscene, pvb, _, pov), kw = frames["config5"]
    kw = dict(kw, **extra)
    for margin in (1.05, 1.25):
        want = jat.derive_overlay_caps(jscene, jvb, jfg.RenderSettings(**kw),
                                       jov, margin=margin)
        got = pat.derive_overlay_caps(pscene, pvb, RenderSettings(**kw), pov,
                                      margin=margin)
        assert got == want and "overlay_candidates" in got


@pytest.mark.parametrize("fit", [(0,), None], ids=["ball", "scene"])
def test_shadow_settings_match_jax(frames, fit):
    (jscene, jvb, _, _), (pscene, pvb, _, _), kw = frames["config5"]
    kw = dict(kw, shadow_fit_batches=fit)
    for margin in (1.05, 1.25):
        want = jat.derive_shadow_settings(jscene, jvb,
                                          jfg.RenderSettings(**kw), margin)
        got = pat.derive_shadow_settings(pscene, pvb, RenderSettings(**kw),
                                         margin)
        assert _settings_dict(got) == _settings_dict(want)
    assert got.shadow_candidates is not None and got.shadow_passes >= 1


@pytest.mark.parametrize("old,new", [
    (dict(max_candidates=512, live_tile_cap=None, raster_tile_cap=128),
     dict(max_candidates=320, live_tile_cap=96, raster_tile_cap=192)),
    (dict(raster_passes=3, dense_tile_cap=64, overlay_candidates=448),
     dict(raster_passes=1, dense_tile_cap=None, span_cap=8)),
    (dict(raster_passes=1, dense_tile_cap=None, pair_budget=8192),
     dict(raster_passes=4, dense_tile_cap=128, live_tile_cap=64,
          raster_tile_cap=None, overlay_max_tiles=64)),
], ids=["uncapped", "passes_shrink", "passes_grow"])
def test_grow_caps_matches_jax(old, new):
    want = jat.grow_caps(jfg.RenderSettings(**old), jfg.RenderSettings(**new))
    got = pat.grow_caps(RenderSettings(**old), RenderSettings(**new))
    assert _settings_dict(got) == _settings_dict(want)


@pytest.mark.parametrize("name", ["config5", "instanced"])
def test_autotune_settings_match_jax(frames, name):
    """``autotune_settings(pair_sampling=2, margin=1.05, materials=,
    overlay=)`` as bench.py calls it, with shadows and light spheres on
    where the frame has them: the JAX package's settings field for field,
    and the probe's escape tiles."""
    (jscene, jvb, jmats, jov), (pscene, pvb, pmats, pov), kw = frames[name]
    kw = dict(kw, pair_sampling=2, enable_shadows=True, show_lights=True)
    want, wp = jat.autotune_settings(jscene, jvb, jfg.RenderSettings(**kw),
                                     margin=1.05, materials=jmats,
                                     overlay=jov)
    got, gp = pat.autotune_settings(pscene, pvb, RenderSettings(**kw),
                                    margin=1.05, materials=pmats,
                                    overlay=pov)
    assert gp.escape_tiles == wp.escape_tiles >= 0
    assert _settings_dict(got) == _settings_dict(want)
    assert got.shadow_candidates is not None
