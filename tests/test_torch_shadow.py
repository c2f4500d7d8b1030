"""The port's shadow mapping (bibim_tpu_torch.ops.shadow and the shadow
stage of pipeline.framegraph) vs the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu import math3d as jm3
from bibim_tpu.ops import shadow as jsh
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import shadow as sh
from bibim_tpu_torch.ops.geometry import assemble_scene_planar
from bibim_tpu_torch.pipeline import KERNELS, PLAIN, RenderSettings
from bibim_tpu_torch.pipeline import framegraph as fg
from tests import torch_port_cases as cases

SIZE = 64


def _np(x):
    return np.asarray(x)


def test_orthographic_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        lo = rng.uniform(-20, -1, 3).astype(np.float32)
        hi = rng.uniform(1, 20, 3).astype(np.float32)
        args = (lo[0], hi[0], lo[1], hi[1], 0.1 + abs(lo[2]), 30 + hi[2])
        want = _np(jm3.orthographic(*args))
        got = m3.orthographic(*(float(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)


def _light_case(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=3).astype(np.float32)
    wmin = rng.uniform(-50, -1, 3).astype(np.float32)
    wmax = rng.uniform(1, 50, 3).astype(np.float32)
    fmin = (wmin * 0.1).astype(np.float32)
    fmax = (wmax * 0.1).astype(np.float32)
    return d, wmin, wmax, fmin, fmax


@pytest.mark.parametrize("fit", [False, True], ids=["scene", "casters"])
@pytest.mark.parametrize("seed", [1, 2])
def test_light_view_proj_matches_jax(seed, fit):
    d, wmin, wmax, fmin, fmax = _light_case(seed)
    if seed == 2:
        d = np.asarray([0.01, -1.0, 0.02], np.float32)  # the x-up branch
    jkw = dict(fit_min=jnp.asarray(fmin), fit_max=jnp.asarray(fmax)) \
        if fit else {}
    pkw = dict(fit_min=cases.t(fmin), fit_max=cases.t(fmax)) if fit else {}
    want = _np(jsh.light_view_proj(jnp.asarray(d), jnp.asarray(wmin),
                                   jnp.asarray(wmax), **jkw))
    got = sh.light_view_proj(cases.t(d), cases.t(wmin), cases.t(wmax),
                             **pkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _shadow_map(seed):
    """The same map in both packages: a JAX light matrix, seeded depth."""
    d, wmin, wmax, _, _ = _light_case(seed)
    lvp = jsh.light_view_proj(jnp.asarray(d), jnp.asarray(wmin),
                              jnp.asarray(wmax))
    depth = np.random.default_rng(seed).uniform(
        0, 1, (SIZE, SIZE)).astype(np.float32)
    jmap = jsh.build_shadow_map(jnp.asarray(depth), lvp, SIZE)
    pmap = sh.build_shadow_map(cases.t(depth), cases.t(lvp), SIZE)
    return jmap, pmap, wmin, wmax


def test_build_shadow_map_bit_equal():
    jmap, pmap, _, _ = _shadow_map(3)
    np.testing.assert_array_equal(pmap.quads.numpy(), _np(jmap.quads))
    assert pmap.size == jmap.size == SIZE


def _world(seed, wmin, wmax, nt=8, npx=1024):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(wmin[k], wmax[k], (nt, npx)).astype(np.float32)
                 for k in range(3))


def _assert_vis_close(got, want):
    """PCF is continuous in the texel coordinate, but a tap's depth test
    flips when the light-space depth lands within an ulp of the stored
    one (XLA:CPU fuses the light-clip FMAs): allow a sliver of pixels."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff > 1e-4).mean() < 1e-3, diff.max()
    assert diff.max() <= 1.0


def test_shadow_factor_matches_jax():
    jmap, pmap, wmin, wmax = _shadow_map(4)
    world = _world(5, wmin, wmax)
    want = jsh.shadow_factor(jmap, tuple(map(jnp.asarray, world)), 2e-3)
    got = sh.shadow_factor(pmap, tuple(map(cases.t, world)), 2e-3)
    _assert_vis_close(got.numpy(), want)
    g = got.numpy()
    assert (g == 1.0).any() and (g < 1.0).any() and (g == 0.0).any()


@pytest.mark.parametrize("cap", [3, 5, 8])
def test_shadow_factor_compact_matches_jax(cap):
    jmap, pmap, wmin, wmax = _shadow_map(6)
    world = _world(7, wmin * 3, wmax * 3)  # many pixels outside the map
    rng = np.random.default_rng(8)
    valid = rng.uniform(0, 1, world[0].shape) > 0.5
    valid[:3] = False  # tiles with nothing covered
    want, jdrop = jsh.shadow_factor_compact(
        jmap, tuple(map(jnp.asarray, world)), jnp.asarray(valid), cap,
        2e-3)
    got, drop = sh.shadow_factor_compact(
        pmap, tuple(map(cases.t, world)), cases.t(valid), cap, 2e-3)
    assert int(drop) == int(jdrop)
    _assert_vis_close(got.numpy(), want)
    if cap == 3:
        assert int(drop) > 0
    with pytest.raises(NotImplementedError):
        sh.shadow_factor_compact(pmap, tuple(map(cases.t, world)),
                                 cases.t(valid), cap, pair=True)


@pytest.fixture(scope="module")
def scene():
    cases.cap_threads()
    jscene, view, proj = cases.jax_scene()
    return jscene, view, proj, interop.scene_data(jscene, device="cpu")


@pytest.mark.parametrize("fit", [None, (0,), (1,)])
def test_fit_ranges_and_bounds_match_jax(scene, fit):
    jscene, view, proj, pscene = scene
    js = jfg.RenderSettings(shadow_fit_batches=fit)
    ps = RenderSettings(shadow_fit_batches=fit)
    tri, _ = jfg._shadow_fit_ranges(jscene, js)
    assert fg._shadow_fit_ranges(pscene, ps) == tri
    jsoup = j_assemble(jscene.batches, view, proj)
    psoup = assemble_scene_planar(pscene.batches, cases.t(view),
                                  cases.t(proj))
    for a, b in zip(fg._world_bounds_planar(psoup.world, tri),
                    jfg._world_bounds_planar(jsoup.world, tri)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)


def test_shadow_pass_matches_jax(scene):
    """The light-view depth pass (the frame's raster with every plane but
    depth dropped) and its map, against the JAX package's pass."""
    jscene, view, proj, pscene = scene
    kw = dict(shadow_size=256, shadow_fit_batches=(0,), max_candidates=512,
              xla_cap=4096, span_cap=64)
    js = jfg.RenderSettings(**kw)
    ps = RenderSettings(**kw)
    tri, _ = jfg._shadow_fit_ranges(jscene, js)
    jmap, jdiag = jfg._shadow_map_planar(
        j_assemble(jscene.batches, view, proj), jscene.lights, js,
        fit_ranges=tri)
    psoup = assemble_scene_planar(pscene.batches, cases.t(view),
                                  cases.t(proj))
    pmap, pdiag = fg._shadow_map_planar(psoup, pscene.lights, ps, KERNELS,
                                        fit_ranges=tri)
    assert [int(x) for x in pdiag] == [0, 0, 0, 0]
    assert [int(x) for x in jdiag] == [0, 0, 0, 0]
    np.testing.assert_allclose(pmap.light_vp.numpy(), _np(jmap.light_vp),
                               rtol=1e-5, atol=1e-6)
    want = _np(jmap.quads)
    got = pmap.quads.numpy()
    np.testing.assert_array_equal(got > 0, want > 0)  # coverage
    # The reference's CPU fallback divides zn / wn through FMA-fused
    # planes, the port keeps the kernel's zn * rcp(wn): a few ulps of the
    # ~0.5 light-space depths.
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=0)
    # The plain raster gives the same map.
    plain, _ = fg._shadow_map_planar(psoup, pscene.lights, ps, PLAIN,
                                     fit_ranges=tri)
    assert torch.equal(plain.quads, pmap.quads)


def test_shadows_frame_matches_jax():
    """A deferred frame with shadows (K2 with the visibility plane on the
    production path) against the JAX package's render_frame."""
    # Production render: 0.1007 % of pixels differ by one LSB (measured;
    # the full render 0.0977 %): XLA:CPU's FMA differences across RGBA16F
    # rounding boundaries (tests/torch_port_cases.py NO_FMA_XLA_FLAGS),
    # held by the check against the JAX frame without FMAs.
    cases.check_stretch_frame(cases.frame_inputs(), cases.SHADOWS,
                              frac_max=(1e-3, 1.25e-3))


def test_shaderball_shadow_fit_batches():
    """ShaderBallScene fits the light frustum to the ball (batch 0)."""
    from bibim_tpu.scene.shaderball import ShaderBallScene as JScene
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    assert ShaderBallScene.shadow_fit_batches == JScene.shadow_fit_batches \
        == (0,)
