"""The shading kernels' redesign (csrc/shade.cu K2, csrc/gbuffer_shade.cu
K5) held through their plain versions on the CPU:

- valid first: a miss pixel's output is the miss value whatever its input
  planes hold, so a kernel may read nothing but its coverage byte there;
  the Pallas kernels in interpret mode, fed the same garbage, agree;
- the per-light prepare step (csrc/shading.cuh prepare_light), written as
  torch ops on ``pack_lights`` rows, gives the per-light values of the
  plain GGX loop, and the loop split around it sums to the same bits;
- the fused fp16 + tone-map tail: the frame asks its shading step for it.

The plain versions themselves are held against the Pallas kernels in
interpret mode by tests/test_torch_shading.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.ops.f16 import f16_round_trip
from bibim_tpu.ops.shading_pallas import (
    shade_sampled_pallas,
    shade_tonemap_pallas,
)
from bibim_tpu.ops.tonemap import tone_map as j_tone_map
from bibim_tpu.scene.lights import make_lights
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops.shading import (
    shade_sampled_plain,
    shade_tonemap_plain,
)
from bibim_tpu_torch.ops.shading_planar import (
    PI,
    dot3,
    fresnel_pow5,
    ggx_light_sum,
    light_terms,
    normalize3,
)
from bibim_tpu_torch.pipeline import KERNELS, RenderSettings, render_frame
from bibim_tpu_torch.scene.lights import LIGHT_ROW, Lights, pack_lights
from bibim_tpu_torch.scene.shaderball import shaderball_lights
from tests import torch_port_cases as cases

SHAPE = (4, 1024)


def _planes(seed):
    rng = np.random.default_rng(seed)

    def p(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, SHAPE).astype(np.float32))

    garbage = torch.tensor(rng.choice(
        np.float32([np.nan, np.inf, -np.inf]), SHAPE))
    return p, torch.tensor(rng.uniform(0, 1, SHAPE) > 0.3), garbage


_TM, _EXPO = 1, 1.3


def _reference_miss_planes(kernel, tail, pl, valid, jlights, vp):
    """The Pallas kernel (interpret mode) on the same planes."""
    j = [jnp.asarray(x.numpy()) for x in pl]
    jvalid = jnp.asarray(valid.numpy())
    if kernel == "sampled":
        jmats = jtq.build_quad_tables(cases.material_maps(),
                                      block_threshold=1024)
        groups = [(jtq.block_prep if isinstance(t, jtq.BlockTable)
                   else jtq.small_prep)(t, j[0], j[1]) for t in jmats]
        hdr = shade_sampled_pallas(
            groups, tuple(j[2:5]), tuple(j[5:8]), tuple(j[8:11]), jvalid,
            jlights, jnp.asarray(vp), jnp.int32(1), interpret=True)
        if not tail:
            return hdr
        return [j_tone_map(f16_round_trip(c), jnp.int32(_TM),
                           jnp.float32(_EXPO)) for c in hdr]
    return shade_tonemap_pallas(
        tuple(j[0:3]), tuple(j[3:6]), tuple(j[6:9]), j[9], j[10], j[11],
        jvalid, jlights, jnp.asarray(vp), jnp.int32(_TM),
        jnp.float32(_EXPO), vis_plane=j[12], vis_light=1,
        ambient=tuple(j[13:16]), quantize=tail, tonemap=tail,
        interpret=True)


@pytest.mark.parametrize("tail", [False, True], ids=["hdr", "fused_tail"])
@pytest.mark.parametrize("kernel", ["sampled", "gbuffer"])
def test_miss_pixels_read_nothing(kernel, tail):
    """NaN and ±inf in every input plane at the miss pixels change no
    output value: the misses hold exactly the miss value (0, and
    tone_map(q16(0)) = 0 with the tail), the covered pixels what the clean
    planes give; the Pallas kernel on the same garbage planes gives 0 at
    the misses too and the plain version's values elsewhere, within the
    reference tests' bound."""
    p, valid, garbage = _planes(3)
    # tests/test_torch_shading.py's point, spot and directional lights.
    jlights = make_lights([
        dict(type=2, dir=(0.3, -1, 0.5), color=(1, 1, 1), intensity=3.0),
        dict(type=0, pos=(2, 3, -1), color=(1, 0.5, 0.2), intensity=10.0),
        dict(type=1, pos=(0, 5, 0), dir=(0, -1, 0), color=(0.2, 0.8, 1.0),
             intensity=5.0, inner_cutoff=0.9, outer_cutoff=0.5),
    ])
    lights = interop.lights(jlights, device="cpu")
    vp = np.float32([0.0, 1.0, -3.0])
    view_pos = torch.tensor(vp)
    tm = dict(enable_tone_mapping=torch.tensor(_TM),
              exposure=torch.tensor(_EXPO))

    def dirty(x):
        return torch.where(valid, x, garbage)

    if kernel == "sampled":
        mats = interop.material_tables(jtq.build_quad_tables(
            cases.material_maps(), block_threshold=1024), device="cpu")
        planes = [p(-2, 3), p(-2, 3)] + [p(-5, 5) for _ in range(3)] \
            + [p(-1, 1) for _ in range(6)]

        def run(pl):
            kw = dict(quantize_hdr=True, tonemap=True, **tm) if tail else {}
            return shade_sampled_plain(
                mats, pl[0], pl[1], tuple(pl[2:5]), tuple(pl[5:8]),
                tuple(pl[8:11]), valid, lights, view_pos, torch.tensor(1),
                **kw)
    else:
        planes = [p(-5, 5) for _ in range(3)] + [p(-1, 1) for _ in range(3)] \
            + [p(0, 1) for _ in range(3)] + [p(0, 1), p(0.05, 1), p(0, 1),
                                             p(0, 1)] \
            + [p(0, 0.2) for _ in range(3)]

        def run(pl):
            return shade_tonemap_plain(
                tuple(pl[0:3]), tuple(pl[3:6]), tuple(pl[6:9]), pl[9], pl[10],
                pl[11], valid, lights, view_pos, tm["enable_tone_mapping"],
                tm["exposure"], vis_plane=pl[12], vis_light=1,
                ambient=tuple(pl[13:16]), quantize=tail, tonemap=tail)

    clean = run(planes)
    dirty_planes = [dirty(x) for x in planes]
    got = run(dirty_planes)
    for c, g in zip(clean, got):
        assert torch.equal(g, c)
        assert bool((g[~valid] == 0.0).all())
        assert bool(torch.isfinite(g[valid]).all())
    want = [np.asarray(w) for w in _reference_miss_planes(
        kernel, tail, dirty_planes, valid, jlights, vp)]
    miss = ~valid.numpy()
    for w in want:
        assert (w[miss] == 0.0).all()
    if kernel == "gbuffer" and not tail:
        for w, g in zip(want, got):  # HDR, neither quantized nor mapped
            diff = np.abs(w - g.numpy()) / (1.0 + np.abs(w))
            assert (diff > 5e-5).mean() < 1e-3 and diff.max() < 2e-3
    else:
        cases.assert_shade_close(want, [g.numpy() for g in got])


def _light_sets():
    shaderball = shaderball_lights("cpu")
    # A spot light whose cone has no width (inner == outer: the divisor
    # becomes 1), a spot light, an unknown type (lit as a point light) and
    # a directional light with a zero direction (|dir| clamps to 1e-20).
    odd = Lights(
        pos=torch.tensor([[1.0, 2.0, -1.0], [-2.0, 1.5, 0.5],
                          [0.5, 3.0, 1.0], [0.0, 0.0, 0.0]]),
        type=torch.tensor([1, 1, 3, 2], dtype=torch.int32),
        dir=torch.tensor([[0.0, -1.0, 0.2], [0.3, -0.8, 0.1],
                          [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]),
        intensity=torch.tensor([3.0, 2.5, 1.0, 0.7]),
        color=torch.tensor([[1.0, 0.9, 0.8], [0.6, 0.7, 1.0],
                            [1.0, 1.0, 1.0], [0.9, 0.9, 0.5]]),
        inner_cutoff=torch.tensor([0.9, 0.95, 0.0, 0.0]),
        outer_cutoff=torch.tensor([0.9, 0.8, 0.0, 0.0]))
    return [shaderball, odd]


def _prepare(rows: torch.Tensor) -> dict:
    """csrc/shading.cuh prepare_light on (L, 16) ``pack_lights`` rows, as
    torch ops: one value per light."""
    d = rows[:, 4:7]
    dlen = torch.clamp(torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                                  + d[:, 2] * d[:, 2]), min=1e-20)
    eps = rows[:, 11] - rows[:, 12]
    return dict(pos=rows[:, 0:3], dn=d / dlen[:, None], outer=rows[:, 12],
                eps_div=torch.where(eps == 0, torch.ones_like(eps), eps),
                intensity=rows[:, 7], color=rows[:, 8:11],
                kind=torch.where(rows[:, 3] == 2, 2,
                                 torch.where(rows[:, 3] == 1, 1, 0)),
                vis=rows[:, 13] > 0.5)


def _ggx_prepared(prep, n_lights, world, n, v, albedo, f0, met, rough,
                  vis=None):
    """csrc/shading.cuh ggx_lights on prepared lights, as torch ops: the
    terms that depend on no light computed once, a directional light
    without the point-light terms, a point light without the spot term."""
    pi = torch.tensor(PI, dtype=torch.float32)
    a = rough * rough
    a2 = a * a
    a2m1 = a2 - 1.0
    r1 = rough + 1.0
    kk = (r1 * r1) / 8.0
    omkk = 1.0 - kk
    ndv = torch.clamp(dot3(n, v), min=0.0)
    gv_v = ndv / (ndv * omkk + kk)
    ndv4 = 4.0 * ndv
    om_met = 1.0 - met
    om_f0 = tuple(1.0 - f0[c] for c in range(3))
    lo = (torch.zeros_like(met),) * 3
    for i in range(n_lights):
        dn = prep["dn"][i]
        kind = int(prep["kind"][i])
        if kind == 2:
            l_vec = tuple(-dn[c].expand_as(met) for c in range(3))
            att = torch.ones_like(met)
        else:
            to_l = tuple(prep["pos"][i][c] - world[c] for c in range(3))
            d2 = torch.clamp(dot3(to_l, to_l), min=1e-20)
            inv_d = 1.0 / torch.sqrt(d2)
            l_vec = tuple(to_l[c] * inv_d for c in range(3))
            att = 1.0 / d2
            if kind == 1:
                theta = -(l_vec[0] * dn[0] + l_vec[1] * dn[1]
                          + l_vec[2] * dn[2])
                att = att * torch.clamp((theta - prep["outer"][i])
                                        / prep["eps_div"][i], 0.0, 1.0)
        h = normalize3(tuple(l_vec[c] + v[c] for c in range(3)))
        ndh = torch.clamp(dot3(n, h), min=0.0)
        denom = ndh * ndh * a2m1 + 1.0
        d = a2 / (PI * denom * denom)
        fres = fresnel_pow5(1.0 - torch.clamp(dot3(h, v), min=0.0))
        ndl = torch.clamp(dot3(n, l_vec), min=0.0)
        g = gv_v * (ndl / (ndl * omkk + kk))
        spec_den = 1.0 / torch.clamp(ndv4 * ndl, min=0.001)
        radiance = att * prep["intensity"][i]
        if vis is not None and bool(prep["vis"][i]):
            radiance = radiance * vis
        new = []
        for c in range(3):
            f = f0[c] + om_f0[c] * fres
            specular = (d * f * g) * spec_den
            kd = (1.0 - f) * om_met
            new.append(lo[c] + (kd * albedo[c] / pi + specular)
                       * (radiance * prep["color"][i][c]) * ndl)
        lo = tuple(new)
    return lo


@pytest.mark.parametrize("vis_light", [-1, 0, 1])
@pytest.mark.parametrize("which", [0, 1], ids=["shaderball", "odd"])
def test_light_prepare_matches_plain_loop(which, vis_light):
    lights = _light_sets()[which]
    rows = pack_lights(lights, vis_light)
    assert rows.shape == (lights.num_lights, LIGHT_ROW)
    prep = _prepare(rows)
    for i in range(lights.num_lights):
        dn, eps = light_terms(lights, i)
        assert torch.equal(prep["dn"][i], torch.stack(dn))
        assert torch.equal(prep["eps_div"][i],
                           torch.where(eps == 0, torch.ones_like(eps), eps))
        assert int(prep["kind"][i]) == {1: 1, 2: 2}.get(
            int(lights.type[i]), 0)
        assert bool(prep["vis"][i]) == (i == vis_light)
    p, _, _ = _planes(which + 5)
    world = tuple(p(-5, 5) for _ in range(3))
    n = normalize3(tuple(p(-1, 1) for _ in range(3)))
    v = normalize3(tuple(p(-1, 1) for _ in range(3)))
    albedo = tuple(p(0, 1) for _ in range(3))
    met, rough = p(0, 1), p(0.02, 1)
    f0 = tuple(0.04 * (1.0 - met) + albedo[c] * met for c in range(3))
    vis = p(0, 1)
    light_vis = None if vis_light < 0 else {vis_light: vis}
    want = ggx_light_sum(lights, world, n, v, albedo, f0, met, rough,
                         light_vis)
    got = _ggx_prepared(prep, lights.num_lights, world, n, v, albedo, f0,
                        met, rough, None if vis_light < 0 else vis)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _recording(kernels, seen: list):
    """Kernels whose shading steps record the tail options the frame asks
    for."""

    def shade(*a, **kw):
        seen.append(("shade", kw.get("quantize_hdr", False),
                     kw.get("tonemap", False)))
        return kernels.shade(*a, **kw)

    def shade_gbuffer(*a, **kw):
        seen.append(("shade_gbuffer", kw.get("quantize", True),
                     kw.get("tonemap", True)))
        return kernels.shade_gbuffer(*a, **kw)

    return kernels._replace(shade=shade, shade_gbuffer=shade_gbuffer)


@pytest.fixture(scope="module")
def inputs():
    return cases.frame_inputs()


_PRODUCTION = dict(outputs="image", max_candidates=64, raster_passes=3,
                   live_tile_cap=31, raster_tile_cap=32, dense_tile_cap=16,
                   span_mid_cap=512, shadow_tile_cap=64,
                   shadow_query_tile_cap=24)


@pytest.mark.parametrize("config", ["config3", "config5"])
def test_fused_tail_frame_equals_torch_tail(inputs, config):
    """Config 3's settings (K2) and config 5's (shadows and analytic IBL:
    K5) at the tests' size: the frame asks its one shading step for the
    fused fp16 + tone-map tail and uses what it returns as the LDR image.
    On the CPU the plain versions run that tail through the torch ops the
    frame used before (ops.shading.hdr_tail), so the two frames are the
    same by construction; on the card the kernels' tail is held
    ``torch.equal`` to the torch tail by chip_smoke.py check_tails and
    tests/test_torch_kernels_cuda.py."""
    from bibim_tpu_torch.ops.ibl import make_ibl_sh

    _, pin = inputs
    extra, ibl = {}, None
    if config == "config5":
        extra = dict(cases.SHADOWS, enable_ibl=True)
        ibl = make_ibl_sh(device="cpu")
    settings = RenderSettings(**{**cases.FRAME_BASE, **_PRODUCTION, **extra})
    seen = []
    image = render_frame(*pin, settings, ibl=ibl,
                         kernels=_recording(KERNELS, seen))["image"]
    step = "shade" if config == "config3" else "shade_gbuffer"
    assert seen == [(step, True, True)]
    assert (image.numpy() != 0).any(axis=-1).mean() > 0.3
