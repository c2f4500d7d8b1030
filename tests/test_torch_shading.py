"""Port sampled shade (K2's plain version, with and without a visibility
plane), G-buffer shade (K5's plain version), material tables, samplers,
planar shading and tone mapping vs the JAX package."""

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
from bibim_tpu.ops.shading_planar import shade_pbr_planar as j_shade_pbr
from bibim_tpu.ops.tonemap import srgb_encode as j_srgb
from bibim_tpu.ops.tonemap import to_u8 as j_to_u8
from bibim_tpu.ops.tonemap import tone_map as j_tone_map
from bibim_tpu.scene.lights import make_lights
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading import q16, shade_sampled, shade_tonemap
from bibim_tpu_torch.ops.shading_planar import shade_pbr_planar
from bibim_tpu_torch.ops.tonemap import srgb_encode, to_u8, tone_map
from bibim_tpu_torch.scene.lights import pack_lights
from tests import torch_port_cases as cases

NT, NPX = 10, 1024


def _lights():
    # tests/test_shading_pallas.py's three light types.
    return make_lights([
        dict(type=2, dir=(0.3, -1, 0.5), color=(1, 1, 1), intensity=3.0),
        dict(type=0, pos=(2, 3, -1), color=(1, 0.5, 0.2), intensity=10.0),
        dict(type=1, pos=(0, 5, 0), dir=(0, -1, 0), color=(0.2, 0.8, 1.0),
             intensity=5.0, inner_cutoff=0.9, outer_cutoff=0.5),
    ])


def _tables_maps():
    # tests/test_shading_pallas.py TestShadeSampledPallas._tables.
    rng = np.random.default_rng(11)

    def m(h, w):
        return rng.integers(0, 256, (h, w, 1), dtype=np.uint8)

    return {
        "metallic": m(64, 64), "roughness": m(64, 64),
        "ao": m(64, 64), "height": m(64, 64),
        "alb_r": m(16, 16), "alb_g": m(16, 16), "alb_b": m(16, 16),
        "nrm_x": m(16, 16), "nrm_y": m(16, 16), "nrm_z": m(16, 16),
    }


def _px(seed):
    # tests/test_shading_pallas.py TestShadeSampledPallas._px.
    rng = np.random.default_rng(seed)

    def p(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (NT, NPX)).astype(np.float32)

    return dict(
        u=p(-2, 3), v=p(-2, 3),
        world=(p(-5, 5), p(-5, 5), p(-5, 5)),
        normal=(p(-1, 1), p(-1, 1), p(-1, 1)),
        tangent=(p(-1, 1), p(-1, 1), p(-1, 1)),
        valid=rng.uniform(0, 1, (NT, NPX)) > 0.3,
    )


_assert_close = cases.assert_shade_close


def _assert_close_rel(want, got):
    for c in range(3):
        w = np.asarray(want[c])
        diff = np.abs(w - np.asarray(got[c])) / (1.0 + np.abs(w))
        assert (diff > 5e-5).mean() < 1e-3, diff.max()
        assert diff.max() < 2e-3, diff.max()


@pytest.fixture(scope="module")
def jtables():
    cases.cap_threads()
    return jtq.build_quad_tables(_tables_maps(), block_threshold=1024)


@pytest.mark.parametrize("seed,vp,nm,deferred", [
    (5, (0.0, 1.0, -3.0), 1, True),
    (6, (1.0, 2.0, 0.0), 0, True),
    (7, (0.0, 0.0, -2.0), 1, False),
], ids=["deferred_nm_on", "deferred_nm_off", "forward_unquantized"])
def test_shade_matches_pallas_interpret(jtables, seed, vp, nm, deferred):
    px = _px(seed)
    lights = _lights()
    groups = []
    for t in jtables:
        if isinstance(t, jtq.BlockTable):
            groups.append(jtq.block_prep(t, jnp.asarray(px["u"]),
                                         jnp.asarray(px["v"])))
        else:
            groups.append(jtq.small_prep(t, jnp.asarray(px["u"]),
                                         jnp.asarray(px["v"])))
    want = shade_sampled_pallas(
        groups, tuple(map(jnp.asarray, px["world"])),
        tuple(map(jnp.asarray, px["normal"])),
        tuple(map(jnp.asarray, px["tangent"])), jnp.asarray(px["valid"]),
        lights, jnp.asarray(vp), jnp.int32(nm), gbuffer_mode=deferred,
        quantize=deferred, interpret=True)
    got = shade_sampled(
        interop.material_tables(jtables, device="cpu"), cases.t(px["u"]),
        cases.t(px["v"]),
        tuple(map(cases.t, px["world"])), tuple(map(cases.t, px["normal"])),
        tuple(map(cases.t, px["tangent"])), cases.t(px["valid"]),
        interop.lights(lights, device="cpu"),
        torch.tensor(vp, dtype=torch.float32),
        torch.tensor(nm, dtype=torch.int32), gbuffer_mode=deferred,
        quantize=deferred)
    (_assert_close if deferred else _assert_close_rel)(
        [np.asarray(w) for w in want], [g.numpy() for g in got])


def test_tables_bit_equal():
    maps = cases.material_maps()
    maps["roughness"] = np.random.default_rng(2).integers(
        0, 256, (256, 256, 1), dtype=np.uint8)  # a ≥ 2^16-texel group
    want = jtq.build_quad_tables(maps, block_threshold=1024)
    got = tq.build_quad_tables(maps, block_threshold=1024, device="cpu")
    conv = interop.material_tables(want, device="cpu")
    assert [type(t).__name__ for t in got] == [type(t).__name__
                                                for t in want]
    for g, c in zip(got, conv):
        assert (g.height, g.width, g.present) == (c.height, c.width,
                                                  c.present)
        np.testing.assert_array_equal(g[0].numpy(), c[0].numpy())


def test_samplers_match_jax(jtables):
    """Plain samplers (the "full" frame's G-buffer path) within f32
    rounding of the JAX samplers, whose blends XLA fuses into FMAs."""
    px = _px(3)
    u, v = jnp.asarray(px["u"]), jnp.asarray(px["v"])
    want = jtq.sample_material(jtables, u, v, use_pallas=False)
    got = tq.sample_material(interop.material_tables(jtables, device="cpu"),
                             cases.t(px["u"]), cases.t(px["v"]))
    assert set(got) == set(want)
    for s in got:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=0, atol=2e-7, err_msg=s)


def test_shade_pbr_planar_matches_jax():
    px = _px(4)
    rng = np.random.default_rng(4)

    def p(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (NT, NPX)).astype(np.float32)

    alb, met, rough, ao = (p(), p(), p()), p(), p(0.05, 1.0), p()
    lights = _lights()
    vp = np.asarray([0.0, 1.0, -3.0], np.float32)
    want = j_shade_pbr(tuple(map(jnp.asarray, px["world"])),
                       tuple(map(jnp.asarray, px["normal"])),
                       tuple(map(jnp.asarray, alb)), jnp.asarray(met),
                       jnp.asarray(rough), jnp.asarray(ao), lights,
                       jnp.asarray(vp))
    got = shade_pbr_planar(tuple(map(cases.t, px["world"])),
                           tuple(map(cases.t, px["normal"])),
                           tuple(map(cases.t, alb)), cases.t(met),
                           cases.t(rough), cases.t(ao),
                           interop.lights(lights, device="cpu"), cases.t(vp))
    _assert_close_rel([np.asarray(w) for w in want],
                      [g.numpy() for g in got])


def test_q16_matches_f16_emulation():
    """The native half cast equals the JAX package's exact integer fp16
    emulation (round to nearest even) on random and boundary values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-70000, 70000, 20000), rng.uniform(-1, 1, 20000),
        np.ldexp(rng.uniform(1, 2, 5000), rng.integers(-30, -10, 5000)),
    ]).astype(np.float32)
    np.testing.assert_array_equal(q16(cases.t(x)).numpy(),
                                  np.asarray(f16_round_trip(jnp.asarray(x))))


def test_tonemap_srgb_u8_match_jax():
    rng = np.random.default_rng(1)
    hdr = rng.uniform(0, 4, (64, 64)).astype(np.float32)
    for enable, expo in ((1, 1.3), (0, 1.0)):
        want = np.asarray(j_tone_map(jnp.asarray(hdr), jnp.int32(enable),
                                     jnp.float32(expo)))
        got = tone_map(cases.t(hdr), torch.tensor(enable),
                       torch.tensor(expo, dtype=torch.float32)).numpy()
        # exp() differs between the two libraries in its last bits; 1 - e
        # keeps that as an absolute error.
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    lin = rng.uniform(-0.1, 1.1, (64, 64, 3)).astype(np.float32)
    want = np.asarray(j_to_u8(j_srgb(jnp.asarray(lin))))
    got = to_u8(srgb_encode(cases.t(lin))).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _gbuffer(seed, nt=NT):
    # tests/test_shading_pallas.py _planes.
    rng = np.random.default_rng(seed)

    def p(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (nt, NPX)).astype(np.float32)

    return dict(
        world=(p(-5, 5), p(-5, 5), p(-5, 5)),
        normal=(p(-1, 1), p(-1, 1), p(-1, 1)),
        albedo=(p(), p(), p()),
        metallic=p(), roughness=p(0.05, 1.0), ao=p(),
        valid=rng.uniform(0, 1, (nt, NPX)) > 0.3,
        vis=p(), ambient=(p(0, 0.2), p(0, 0.2), p(0, 0.2)),
    )


@pytest.mark.parametrize("opts", [
    dict(tm=1, expo=1.3),
    dict(tm=0, expo=2.0, nt=7),
    dict(tm=1, expo=1.0, vis=True, ambient=True),
    dict(tm=1, expo=1.0, vis=True, vis_light=2),
    dict(tm=1, expo=0.7, ambient=True, quantize=False),
    dict(tm=1, expo=1.0, vis=True, ambient=True, quantize=False,
         tonemap=False),
    dict(tm=1, expo=1.0, no_lights=True),
], ids=["defaults", "tonemap_off_nt_padding", "vis_ambient", "vis_light2",
        "unquantized", "frame_options", "zero_lights"])
def test_gbuffer_shade_matches_pallas_interpret(opts):
    """K5's plain version vs ``shade_tonemap_pallas`` (interpret) at the
    reference test's _assert_close bound (relative where the HDR output is
    neither quantized nor tone mapped)."""
    g = _gbuffer(20 + len(opts), opts.get("nt", NT))
    lights = _lights()
    if opts.get("no_lights"):
        lights = make_lights([])
    vp = np.asarray([0.0, 1.0, -3.0], np.float32)
    jkw = dict(vis_light=opts.get("vis_light", 0),
               quantize=opts.get("quantize", True),
               tonemap=opts.get("tonemap", True))
    pkw = dict(jkw)
    if opts.get("vis"):
        jkw["vis_plane"] = jnp.asarray(g["vis"])
        pkw["vis_plane"] = cases.t(g["vis"])
    if opts.get("ambient"):
        jkw["ambient"] = tuple(map(jnp.asarray, g["ambient"]))
        pkw["ambient"] = tuple(map(cases.t, g["ambient"]))
    jargs = (tuple(map(jnp.asarray, g["world"])),
             tuple(map(jnp.asarray, g["normal"])),
             tuple(map(jnp.asarray, g["albedo"])),
             jnp.asarray(g["metallic"]), jnp.asarray(g["roughness"]),
             jnp.asarray(g["ao"]))
    if opts.get("no_lights"):
        # The reference kernel's light packing cannot stack zero rows
        # (shading_pallas._pack_lights runs before its zero-light branch),
        # so zero lights are held against its planar oracle chain:
        # shade_pbr_planar → mask → fp16 → tone map.
        hdr = j_shade_pbr(*jargs, lights, jnp.asarray(vp))
        hdr = [f16_round_trip(jnp.where(jnp.asarray(g["valid"]), c, 0.0))
               for c in hdr]
        want = [j_tone_map(c, jnp.int32(opts["tm"]),
                           jnp.float32(opts["expo"])) for c in hdr]
    else:
        want = shade_tonemap_pallas(
            *jargs, jnp.asarray(g["valid"]), lights, jnp.asarray(vp),
            jnp.int32(opts["tm"]), jnp.float32(opts["expo"]),
            interpret=True, **jkw)
    got = shade_tonemap(
        tuple(map(cases.t, g["world"])), tuple(map(cases.t, g["normal"])),
        tuple(map(cases.t, g["albedo"])), cases.t(g["metallic"]),
        cases.t(g["roughness"]), cases.t(g["ao"]), cases.t(g["valid"]),
        interop.lights(lights, device="cpu"), cases.t(vp),
        torch.tensor(opts["tm"]),
        torch.tensor(opts["expo"], dtype=torch.float32), **pkw)
    assert got[0].shape == (opts.get("nt", NT), NPX)
    close = _assert_close if jkw["quantize"] or jkw["tonemap"] \
        else _assert_close_rel
    close([np.asarray(w) for w in want], [c.numpy() for c in got])
    if opts.get("no_lights") or not opts.get("ambient"):
        return
    # The ambient planes replace 0.03·albedo·ao on covered pixels only.
    assert not np.array_equal(
        got[0].numpy(),
        shade_tonemap(*(x for x in (
            tuple(map(cases.t, g["world"])),
            tuple(map(cases.t, g["normal"])),
            tuple(map(cases.t, g["albedo"])), cases.t(g["metallic"]),
            cases.t(g["roughness"]), cases.t(g["ao"]), cases.t(g["valid"]),
            interop.lights(lights, device="cpu"), cases.t(vp),
            torch.tensor(opts["tm"]),
            torch.tensor(opts["expo"], dtype=torch.float32))),
            **{k: v for k, v in pkw.items() if k != "ambient"})[0].numpy())


def test_gbuffer_shade_miss_pixels_are_black():
    g = _gbuffer(3)
    got = shade_tonemap(
        tuple(map(cases.t, g["world"])), tuple(map(cases.t, g["normal"])),
        tuple(map(cases.t, g["albedo"])), cases.t(g["metallic"]),
        cases.t(g["roughness"]), cases.t(g["ao"]),
        torch.zeros((NT, NPX), dtype=torch.bool),
        interop.lights(_lights(), device="cpu"),
        torch.zeros(3), torch.tensor(1), torch.tensor(1.0),
        vis_plane=cases.t(g["vis"]), vis_light=0,
        ambient=tuple(map(cases.t, g["ambient"])))
    for c in got:
        assert (c.numpy() == 0).all()


@pytest.mark.parametrize("vis_light", [0, 1])
def test_shade_with_visibility_matches_pallas_interpret(jtables, vis_light):
    """K2's plain version with a visibility plane vs
    ``shade_sampled_pallas(vis_plane=...)`` (interpret)."""
    px = _px(30 + vis_light)
    vis = np.random.default_rng(8).uniform(0, 1, (NT, NPX)).astype(
        np.float32)
    lights = _lights()
    vp = (0.0, 1.0, -3.0)
    groups = []
    for t in jtables:
        prep = jtq.block_prep if isinstance(t, jtq.BlockTable) \
            else jtq.small_prep
        groups.append(prep(t, jnp.asarray(px["u"]), jnp.asarray(px["v"])))
    want = shade_sampled_pallas(
        groups, tuple(map(jnp.asarray, px["world"])),
        tuple(map(jnp.asarray, px["normal"])),
        tuple(map(jnp.asarray, px["tangent"])), jnp.asarray(px["valid"]),
        lights, jnp.asarray(vp), jnp.int32(1),
        vis_plane=jnp.asarray(vis), vis_light=vis_light, interpret=True)
    args = (interop.material_tables(jtables, device="cpu"), cases.t(px["u"]),
            cases.t(px["v"]), tuple(map(cases.t, px["world"])),
            tuple(map(cases.t, px["normal"])),
            tuple(map(cases.t, px["tangent"])), cases.t(px["valid"]),
            interop.lights(lights, device="cpu"),
            torch.tensor(vp, dtype=torch.float32),
            torch.tensor(1, dtype=torch.int32))
    got = shade_sampled(*args, vis_plane=cases.t(vis), vis_light=vis_light)
    _assert_close([np.asarray(w) for w in want], [g.numpy() for g in got])
    unlit = shade_sampled(*args)
    assert not np.array_equal(got[0].numpy(), unlit[0].numpy())


def test_shade_pbr_planar_visibility_and_ambient_match_jax():
    """The reference's ``light_vis`` and ``ambient`` arguments."""
    g = _gbuffer(9)
    lights = _lights()
    vp = np.asarray([0.0, 0.0, -2.0], np.float32)
    want = j_shade_pbr(tuple(map(jnp.asarray, g["world"])),
                       tuple(map(jnp.asarray, g["normal"])),
                       tuple(map(jnp.asarray, g["albedo"])),
                       jnp.asarray(g["metallic"]),
                       jnp.asarray(g["roughness"]), jnp.asarray(g["ao"]),
                       lights, jnp.asarray(vp),
                       light_vis={2: jnp.asarray(g["vis"])},
                       ambient=tuple(map(jnp.asarray, g["ambient"])))
    got = shade_pbr_planar(tuple(map(cases.t, g["world"])),
                           tuple(map(cases.t, g["normal"])),
                           tuple(map(cases.t, g["albedo"])),
                           cases.t(g["metallic"]), cases.t(g["roughness"]),
                           cases.t(g["ao"]),
                           interop.lights(lights, device="cpu"),
                           cases.t(vp), light_vis={2: cases.t(g["vis"])},
                           ambient=tuple(map(cases.t, g["ambient"])))
    _assert_close_rel([np.asarray(w) for w in want],
                      [c.numpy() for c in got])


def test_pack_lights_visibility_flag():
    """Row layout of the reference's _pack_lights: column 13 flags the
    shadow-casting light."""
    from bibim_tpu.ops.shading_pallas import _pack_lights

    lights = _lights()
    for vis_light in (-1, 0, 2):
        want = np.asarray(_pack_lights(lights, lights.num_lights, vis_light))
        got = pack_lights(interop.lights(lights, device="cpu"),
                          vis_light).numpy()
        np.testing.assert_array_equal(got, want)
