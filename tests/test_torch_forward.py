"""Forward lighting (``deferred=False``) in the port against the JAX
package on the CPU: K2's plain version at ``quantize=False`` against the
Pallas kernel's forward mode (``gbuffer_mode=False``, interpret mode),
``_forward_hdr`` with and without IBL and shadows (the plain chain, and
the production path: K2 at ``quantize=False``, or the sampled planes and
K5, each with the fp16 + tone-map tail), which kernel each forward frame
launches, and the forward frame with shadows and IBL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import ibl as jibl
from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.ops.shading_pallas import shade_sampled_pallas
from bibim_tpu.ops.tonemap import tone_map as j_tone_map
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops.shading import shade_sampled_plain
from bibim_tpu_torch.pipeline import KERNELS, Kernels, RenderSettings
from bibim_tpu_torch.pipeline import framegraph as fg
from tests import torch_port_cases as cases

NT, TX = 6, 2


@pytest.fixture(scope="module")
def inputs():
    return cases.frame_inputs()


def _spy(calls: dict) -> Kernels:
    """KERNELS, recording each entry point's keyword arguments."""
    def wrap(name, fn):
        def run(*args, **kw):
            calls.setdefault(name, []).append(kw)
            return fn(*args, **kw)
        return run

    return Kernels(*(wrap(n, f) for n, f in zip(Kernels._fields, KERNELS)))


def test_forward_k2_matches_pallas_forward_mode():
    """K2 at the forward frame's setting (``quantize=False``: raw samples,
    no G-buffer clear or fp16) against ``shade_sampled_pallas(
    gbuffer_mode=False, quantize=False)`` in interpret mode, NaN / ±inf in
    every input plane at the misses: both write 0 there (the Pallas kernel
    masks its output; the port's kernel reads nothing at a miss), and the
    covered pixels agree within the reference tests' bound."""
    cases.cap_threads()
    rng = np.random.default_rng(11)
    shape = (4, 1024)

    def p(lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    valid = rng.uniform(0, 1, shape) > 0.3
    garbage = rng.choice(np.float32([np.nan, np.inf, -np.inf]), shape)
    planes = [p(-2, 3), p(-2, 3)] + [p(-5, 5) for _ in range(3)] \
        + [p(-1, 1) for _ in range(6)]
    planes = [np.where(valid, x, garbage) for x in planes]
    from bibim_tpu.scene.shaderball import shaderball_lights

    jl = shaderball_lights()
    vp = np.float32([0.0, 1.0, -3.0])
    jmats = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    j = [jnp.asarray(x) for x in planes]
    groups = [(jtq.block_prep if isinstance(t, jtq.BlockTable)
               else jtq.small_prep)(t, j[0], j[1]) for t in jmats]
    want = shade_sampled_pallas(
        groups, tuple(j[2:5]), tuple(j[5:8]), tuple(j[8:11]),
        jnp.asarray(valid), jl, jnp.asarray(vp), jnp.int32(1),
        gbuffer_mode=False, quantize=False, interpret=True)
    pl = [torch.tensor(x) for x in planes]
    got = shade_sampled_plain(
        interop.material_tables(jmats, device="cpu"), pl[0], pl[1],
        tuple(pl[2:5]), tuple(pl[5:8]), tuple(pl[8:11]),
        torch.tensor(valid), interop.lights(jl, device="cpu"),
        torch.tensor(vp), torch.tensor(1), quantize=False)
    for w, g in zip(want, got):
        assert (np.asarray(w)[~valid] == 0.0).all()
        assert bool((g[~torch.tensor(valid)] == 0.0).all())
    cases.assert_shade_close([np.asarray(w) for w in want],
                             [g.numpy() for g in got])


def _light_vis(seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (NT, cases.TILE_H * cases.TILE_W)).astype(np.float32)


@pytest.mark.parametrize("ibl", [False, True], ids=["no_ibl", "ibl"])
@pytest.mark.parametrize("shadows", [False, True], ids=["lit", "shadowed"])
def test_forward_hdr_matches_jax(inputs, ibl, shadows):
    """``_forward_hdr`` on seeded pixels against the JAX package's (run op
    by op): the plain chain's masked HDR planes within the shading bound
    and 0 at every miss; the production path's LDR planes (K2 without
    IBL, else K5 on the unquantized sampled planes and their IBL ambient,
    with the fp16 + tone-map tail) against the JAX HDR planes through
    ``_q16`` and ``tone_map``."""
    jin, pin = inputs
    jpx, ppx = cases.seeded_pixels(3, NT, TX)
    jmats, pmats = jin[3], pin[3]
    jl, pl = jin[0].lights, pin[0].lights
    kw = dict(deferred=False, enable_ibl=ibl, width=TX * cases.TILE_W,
              height=NT // TX * cases.TILE_H)
    js, ps = jfg.RenderSettings(**kw), RenderSettings(**kw)
    vb = jfg.ViewBlock(view=jin[1].view, proj=jin[1].proj,
                       view_pos=jnp.asarray([0.2, 0.3, -2.0]),
                       enable_normal_map=jnp.int32(1))
    pvb = interop.view_block(vb, device="cpu")
    jprobe = jibl.make_ibl_sh() if ibl else None
    pprobe = interop.ibl(jprobe, device="cpu") if ibl else None
    jvis = pvis = None
    if shadows:
        vis = _light_vis(4)
        jvis, pvis = {0: jnp.asarray(vis)}, {0: torch.tensor(vis)}
    want, valid = jfg._forward_hdr(jpx, jmats, jl, vb, js, light_vis=jvis,
                                   ibl=jprobe)
    want = [np.asarray(w) for w in want]
    miss = ~np.asarray(valid)
    hdr, none = fg._forward_hdr(ppx, pmats, pl, pvb, pin[2], ps, KERNELS,
                                pvis, pprobe, False, [])
    assert none is None
    for g in hdr:
        assert (g.numpy()[miss] == 0.0).all()
    cases.assert_shade_close(want, [g.numpy() for g in hdr])
    calls = {}
    none, ldr = fg._forward_hdr(ppx, pmats, pl, pvb, pin[2], ps,
                                _spy(calls), pvis, pprobe, True, [])
    assert none is None
    assert set(calls) == ({"sample_block", "sample_small", "shade_gbuffer"}
                          if ibl else {"shade"})
    if not ibl:
        assert calls["shade"][0]["quantize"] is False
    want_ldr = [np.asarray(j_tone_map(jnp.asarray(w).astype(jnp.float16)
                                      .astype(jnp.float32), jnp.int32(1),
                                      jnp.float32(1.0))) for w in want]
    cases.assert_shade_close(want_ldr, [g.numpy() for g in ldr])
    for g in ldr:
        assert (g.numpy()[miss] == 0.0).all()


def test_forward_frame_kernels(inputs):
    """Which kernels the production forward frame launches: K2 at
    ``quantize=False`` with the fp16 + tone-map tail (no K5, no sampler);
    with IBL the samplers and K5; at 2 taps the samplers twice and K5,
    never K2; a forward G-buffer view shows the cleared (zero) planes and
    launches no shading kernel."""
    _, pin = inputs
    base = dict(cases.FRAME_BASE, deferred=False, outputs="image",
                live_tile_cap=31)
    from bibim_tpu.ops import ibl as j_ibl

    probe = interop.ibl(j_ibl.make_ibl_sh(), device="cpu")
    for kw, want in ((dict(), {"shade": 1}),
                     (dict(enable_ibl=True), {"sample_block": 1,
                                              "sample_small": 1,
                                              "shade_gbuffer": 1}),
                     (dict(aniso_taps=2), {"sample_block": 2,
                                           "sample_small": 2,
                                           "shade_gbuffer": 1}),
                     (dict(gbuffer_viz=2), {})):
        calls = {}
        out = fg.render_frame(*pin, RenderSettings(**{**base, **kw}),
                              ibl=probe, kernels=_spy(calls))
        got = {k: len(v) for k, v in calls.items()
               if k in ("shade", "shade_gbuffer", "sample_block",
                        "sample_small", "sample_mip_block")}
        assert got == want, (kw, got)
        if "shade" in calls:
            kw0 = calls["shade"][0]
            assert kw0["quantize"] is False and kw0["tonemap"] is True
            assert kw0["quantize_hdr"] is True
        if kw == dict(gbuffer_viz=2):
            img = out["image"].numpy()
            full = fg.render_frame(*pin, RenderSettings(
                **{**base, **kw, "outputs": "full"}))
            assert full["gbuffer"] == {}
            assert not full["hdr"].any()
            # Only the light spheres and the gizmo draw over the cleared
            # planes.
            assert (img == 0).all(axis=-1).mean() > 0.9


def test_forward_shadows_ibl_frame_matches_jax(inputs):
    """Forward + shadows + analytic IBL against the JAX package's
    render_frame: the plain chain and the production path (shadow pass on
    K1, compacted PCF, K6 / K7 sampling, IBL ambient, K5), with compacted
    capacities and zero drops, at the golden bound."""
    cases.check_stretch_frame(
        inputs, dict(cases.SHADOWS, enable_ibl=True, deferred=False),
        jibl.make_ibl_sh(), ibl="sh")
