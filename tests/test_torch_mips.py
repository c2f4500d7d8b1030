"""The port's trilinear mip tables and samplers (bibim_tpu_torch.ops.
texture_quad: table builds, the mip pyramid, the LOD / footprint geometry,
K8's plain version, the quad-layout oracle, material routing) and K2's
plain version with the mip-block and material-routed small groups, vs the
JAX package on the CPU (Pallas kernels in interpret mode).

The LOD is floored into a level: where log2(rho) lies within a few ulps of
an integer, XLA:CPU's FMA contraction of rho (ROADMAP queue 3) or its log2
can pick the neighbouring level. The geometry test bounds that: integer
planes equal on >= 99.9 % of pixels and different only where
|lod - round(lod)| < 1e-5 (on these inputs: equal everywhere); value
comparisons skip the pixels whose integer planes differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.assets.image import build_mip_pyramid as j_mip_pyramid
from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.ops.shading_pallas import shade_sampled_pallas
from bibim_tpu.ops.shading_planar import apply_normal_map as j_normal_map
from bibim_tpu.scene.lights import make_lights
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading import shade_sampled
from bibim_tpu_torch.pipeline import KERNELS, PLAIN
from bibim_tpu_torch.scene.cube import cube_material_tables
from tests import torch_port_cases as cases

TH, TW = 8, 128
NT = 48
INT_PLANES = ("idx", "lx", "ly", "pxi", "pyi")


def _uv(seed, nt=NT, e_lo=-3.0, e_hi=8.0, base=64.0):
    """Tiled planar uv, one rotated affine map per tile whose scale gives
    2^e texels per pixel on a ``base``² level 0 (e per tile in
    [e_lo, e_hi)), offsets in [-2, 2) so REPEAT wraps both ways."""
    rng = np.random.default_rng(seed)
    py, px = np.meshgrid(np.arange(TH), np.arange(TW), indexing="ij")
    px = px.reshape(-1).astype(np.float32)
    py = py.reshape(-1).astype(np.float32)
    s = (2.0 ** rng.uniform(e_lo, e_hi, nt) / base)[:, None]
    ang = rng.uniform(0, 2 * np.pi, nt)[:, None]
    u = rng.uniform(-2, 2, nt)[:, None] + s * (np.cos(ang) * px
                                               - np.sin(ang) * py)
    v = rng.uniform(-2, 2, nt)[:, None] + s * 1.3 * (np.sin(ang) * px
                                                     + np.cos(ang) * py)
    return u.astype(np.float32), v.astype(np.float32)


def _mat(seed, nt=NT, n_mats=2):
    return np.random.default_rng(seed).integers(
        0, n_mats, (nt, TH * TW)).astype(np.int32)


def _alb(seed, base, max_levels=None, ch=3, pyramid=tq.build_mip_pyramid):
    img = np.random.default_rng(seed).integers(0, 256, (base, base, ch),
                                               dtype=np.uint8)
    mips = pyramid(img, max_levels)
    return {s: [m[:, :, k:k + 1] for m in mips]
            for k, s in enumerate(("alb_r", "alb_g", "alb_b")[:ch])}


def _materials(pyramid=tq.build_mip_pyramid):
    """Per-material mip maps: a 32² pyramid down to 1×1 (built levels
    32..4, parent taps stored at 4×4), a 64² pyramid cut at 4 levels
    (64..8, a true last level), and 4×4 single-level neutral maps."""
    out = []
    for seed, base, ml in ((1, 32, None), (2, 64, 4)):
        m = _alb(seed, base, ml, pyramid=pyramid)
        rng = np.random.default_rng(seed + 10)
        for s in ("metallic", "roughness", "ao"):
            m[s] = [rng.integers(0, 256, (4, 4, 1), dtype=np.uint8)]
        out.append(m)
    return out


@pytest.fixture(scope="module")
def merged():
    """(JAX merged block binding, the same carried into the port)."""
    cases.cap_threads()
    j = jtq.merge_mip_block_materials(tuple(
        jtq.build_mip_block_tables(m) for m in _materials()))
    return j, interop.material_tables(j, device="cpu")


def _t(x):
    return cases.t(x)


@pytest.mark.parametrize("shape,dtype,max_levels", [
    ((64, 64, 4), np.uint8, None), ((48, 20, 3), np.uint8, None),
    ((32, 32, 3), np.uint8, 3), ((16, 16, 1), np.float32, None),
], ids=["square", "odd_edges", "max_levels", "float"])
def test_mip_pyramid_matches_jax(shape, dtype, max_levels):
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
           else rng.uniform(0, 1, shape).astype(dtype))
    want = j_mip_pyramid(img, max_levels)
    got = tq.build_mip_pyramid(img, max_levels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["block", "quad"])
def test_tables_byte_equal(layout):
    """Per-material builds and the merge, byte for byte and with the same
    static geometry (``cube_material_tables`` builds the cube binding the
    same way from two albedos)."""
    build = {"block": (jtq.build_mip_block_tables, tq.build_mip_block_tables,
                       jtq.merge_mip_block_materials,
                       tq.merge_mip_block_materials),
             "quad": (jtq.build_mip_quad_tables, tq.build_mip_quad_tables,
                      jtq.merge_mip_quad_materials,
                      tq.merge_mip_quad_materials)}[layout]
    jb, pb, jm, pm = build
    j_each = [jb(m) for m in _materials(j_mip_pyramid)]
    p_each = [pb(m, device="cpu") for m in _materials()]
    for jt, pt in list(zip(j_each, p_each)) + [(jm(tuple(j_each)),
                                                pm(tuple(p_each)))]:
        want = interop.material_tables(jt, device="cpu")
        assert [type(t).__name__ for t in pt] == [type(t).__name__
                                                  for t in want]
        for g, w in zip(pt, want):
            assert tuple(g[1:]) == tuple(w[1:])
            assert torch.equal(g[0], w[0])
    if layout == "quad":
        return
    rng = np.random.default_rng(3)
    albs = [rng.integers(0, 256, (n, n, 4), dtype=np.uint8) for n in (32, 16)]
    got = cube_material_tables(albs, device="cpu")
    assert [type(t).__name__ for t in got] == ["MipBlockMulti",
                                               "MipQuadMulti"]
    assert got[0].heights == ((32, 16, 8, 4), (16, 8, 4))
    assert got[0].last_parent == (True, True)
    assert got[1].heights == ((4,), (4,)) and got[1].quads.shape == (32, 32)


def _jax_lod(table, mat, u, v):
    lod = None
    for mi in range(len(table.heights)):
        m = jtq.quad_lod_planar(jnp.asarray(u), jnp.asarray(v), TH, TW,
                                table.heights[mi][0], table.widths[mi][0])
        lod = m if lod is None else jnp.where(jnp.asarray(mat) == mi, m, lod)
    return np.asarray(lod)


def _geometry_pair(table_j, table_p, mat, u, v):
    gj = jtq._mip_block_geometry(table_j, jnp.asarray(mat), jnp.asarray(u),
                                 jnp.asarray(v), TH, TW)
    gp = tq._mip_block_geometry(table_p, _t(mat), _t(u), _t(v), TH, TW)
    same = np.ones(u.shape, bool)
    for k in INT_PLANES:
        same &= np.asarray(gj[k]) == gp[k].numpy()
    return gj, gp, same


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_matches_jax(merged, seed):
    """Integer planes at the LOD bound above; tx/ty/tx2/ty2 within 2 ulps
    and frac within 5e-7 (log2 ulps: 4 ulps of a lod below 8) where they
    agree; levels 0..3 all selected; uv wraps below 0 and above 1."""
    j, p = merged
    u, v = _uv(seed)
    assert (u < 0).any() and (u > 1).any() and (v < 0).any()
    mat = _mat(seed)
    gj, gp, same = _geometry_pair(j[0], p[0], mat, u, v)
    lod = _jax_lod(j[0], mat, u, v)
    assert same.mean() >= 0.999
    assert (np.abs(lod - np.round(lod))[~same] < 1e-5).all()
    assert set(np.unique(gp["l0"].numpy())) == {0, 1, 2, 3}
    for k in ("tx", "ty", "tx2", "ty2"):
        assert cases.ulps(gp[k].numpy()[same], np.asarray(gj[k])[same]).max() \
            <= 2, k
    np.testing.assert_allclose(gp["frac"].numpy()[same],
                               np.asarray(gj["frac"])[same], rtol=0,
                               atol=5e-7)


def test_blend_matches_jax_on_jax_geometry(merged):
    """The plain blend fed the JAX package's own geometry planes: the 8-tap
    sum vs its 41-tap XLA blend and the Pallas kernel (interpret), at the
    reference test's 3e-7 bound (XLA:CPU fuses the blend's FMAs)."""
    j, p = merged
    u, v = _uv(3)
    mat = _mat(3)
    ju, jv, jm = jnp.asarray(u), jnp.asarray(v), jnp.asarray(mat)
    g = jtq._mip_block_geometry(j[0], jm, ju, jv, TH, TW)
    got = tq.mip_block_blend(p[0].blocks,
                             {k: _t(np.asarray(x).reshape(-1))
                              for k, x in g.items()}, 3, 3)
    for want in (jtq.sample_mip_block(j[0], jm, ju, jv, TH, TW),
                 jtq.sample_mip_block_pallas(j[0], jm, ju, jv, TH, TW,
                                             interpret=True)):
        for k, slot in enumerate(j[0].present):
            np.testing.assert_allclose(got[k].numpy().reshape(u.shape),
                                       np.asarray(want[slot]), rtol=3e-7,
                                       atol=3e-7, err_msg=slot)


@pytest.mark.parametrize("fn", [tq.sample_mip_block_kernel,
                                tq.sample_mip_block],
                         ids=["wrapper", "plain"])
def test_plain_k8_matches_pallas_interpret(merged, fn):
    """K8's plain version (and its wrapper on CPU tensors) vs
    ``sample_mip_block_pallas`` (interpret) and ``sample_mip_block``."""
    j, p = merged
    u, v = _uv(4)
    mat = _mat(4)
    _, _, same = _geometry_pair(j[0], p[0], mat, u, v)
    assert same.mean() >= 0.999
    got = fn(p[0], _t(mat), _t(u), _t(v), TH, TW)
    ju, jv, jm = jnp.asarray(u), jnp.asarray(v), jnp.asarray(mat)
    for want in (jtq.sample_mip_block_pallas(j[0], jm, ju, jv, TH, TW,
                                             interpret=True),
                 jtq.sample_mip_block(j[0], jm, ju, jv, TH, TW)):
        assert set(got) == set(want)
        for s in got:
            np.testing.assert_allclose(got[s].numpy()[same],
                                       np.asarray(want[s])[same], rtol=3e-7,
                                       atol=3e-7, err_msg=s)


def test_block_layout_matches_quad_oracle():
    """tests/test_texture_quad.py's oracle test: the block layout equals
    the paired quad layout bit for bit (same taps, same order); the port's
    quad oracle against the JAX package's."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 32, 1), dtype=np.uint8)
    mips = [m for m in tq.build_mip_pyramid(img) if m.shape[0] >= 4]
    u, v = _uv(5, base=32.0)
    (quad,) = tq.build_mip_quad_tables({"ao": mips}, device="cpu")
    (block,) = tq.build_mip_block_tables({"ao": mips}, device="cpu")
    want = tq.sample_mip_table(quad, _t(u), _t(v), TH, TW)
    got = tq.sample_mip_block(block, None, _t(u), _t(v), TH, TW)
    assert torch.equal(want["ao"], got["ao"])
    (jquad,) = jtq.build_mip_quad_tables({"ao": mips})
    jwant = jtq.sample_mip_table(jquad, jnp.asarray(u), jnp.asarray(v), TH,
                                 TW)
    np.testing.assert_allclose(want["ao"].numpy(), np.asarray(jwant["ao"]),
                               rtol=3e-7, atol=3e-7)


def _const(value, sizes):
    return [np.full((s, s, 1), value, np.uint8) for s in sizes]


@pytest.mark.parametrize("layout", ["block", "paired_quad"])
@pytest.mark.parametrize("kernels", [None, KERNELS, PLAIN],
                         ids=["xla", "kernels", "plain"])
def test_multi_material_routing(layout, kernels):
    """tests/test_texture_quad.py:168-184 and :243-265: per-pixel material
    ids select each material's constant pyramid."""
    if layout == "block":
        m0 = tq.build_mip_block_tables({"ao": _const(40, (16, 8, 4))},
                                       device="cpu")
        m1 = tq.build_mip_block_tables({"ao": _const(200, (32, 16, 8, 4))},
                                       device="cpu")
        merged = tq.merge_mip_block_materials((m0, m1))
    else:
        m0 = tq.build_mip_quad_tables({"ao": _const(40, (16, 8))},
                                      device="cpu")
        m1 = tq.build_mip_quad_tables({"ao": _const(200, (32, 16))},
                                      device="cpu")
        merged = tq.merge_mip_quad_materials((m0, m1))
        assert merged[0].paired
    u, v = _uv(6, nt=4)
    mat = (np.arange(u.size, dtype=np.int32) % 2).reshape(u.shape)
    out = tq.sample_material_mips_multi(merged, _t(mat), _t(u), _t(v), TH,
                                        TW, kernels)
    got = out["ao"].numpy().ravel()
    want = np.where(np.arange(got.size) % 2 == 0, 40 / 255.0, 200 / 255.0)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("kernels", [None, KERNELS],
                         ids=["xla", "kernels"])
def test_sample_material_mips_multi_matches_jax(merged, kernels):
    """The merged binding (block group + single-level small group) against
    ``sample_material_mips_multi`` with ``use_pallas`` (interpret: K8 and
    K7 at the routed index) or without (XLA samplers)."""
    j, p = merged
    u, v = _uv(7)
    mat = _mat(7)
    _, _, same = _geometry_pair(j[0], p[0], mat, u, v)
    want = jtq.sample_material_mips_multi(
        j, jnp.asarray(mat), jnp.asarray(u), jnp.asarray(v), TH, TW,
        use_pallas=kernels is not None, interpret=True)
    got = tq.sample_material_mips_multi(p, _t(mat), _t(u), _t(v), TH, TW,
                                        kernels)
    assert set(got) == set(want) == set(tq.SLOTS)
    for s in got:
        np.testing.assert_allclose(got[s].numpy()[same],
                                   np.asarray(want[s])[same], rtol=3e-7,
                                   atol=3e-7, err_msg=s)


def test_sample_material_mips_multi_routes(merged):
    """Block groups reach K8, single-level small groups K7 at the
    material-routed row index; multi-level quad groups the quad oracle."""
    _, p = merged
    seen = []

    class Spy:
        def sample_mip_block(self, t, mat, u, v, th, tw):
            seen.append("k8")
            return tq.sample_mip_block(t, mat, u, v, th, tw)

        def sample_small(self, quads, idx, tx, ty, present):
            seen.append(("k7", int(idx.min()), int(idx.max())))
            return tq.sample_rows_small_plain(quads, idx, tx, ty, present)

    u, v = _uv(8, nt=2)
    mat = np.ones(u.shape, np.int32)
    tq.sample_material_mips_multi(p, _t(mat), _t(u), _t(v), TH, TW, Spy())
    # Material 1's 16 rows of the 4×4 neutral table follow material 0's.
    assert seen == ["k8", ("k7", 16, 31)]
    seen.clear()
    quad = tq.merge_mip_quad_materials(tuple(
        tq.build_mip_quad_tables(m, device="cpu") for m in _materials()))
    assert any(t.paired for t in quad)
    tq.sample_material_mips_multi(quad, _t(mat), _t(u), _t(v), TH, TW,
                                  Spy())
    assert seen == [("k7", 16, 31)]


@pytest.mark.parametrize("max_levels", [None, 3],
                         ids=["stored_parent", "true_last_level"])
def test_deepest_level(max_levels):
    """Views far enough back that most pixels select the deepest built
    level: with a stored parent (the pyramid continues to 1×1) frac still
    blends into it; a pyramid cut at a 4-divisible level forces frac to 0
    there. The port against the JAX package."""
    m = _alb(11, 32, max_levels)
    (jt,) = jtq.build_mip_block_tables(m)
    (pt,) = interop.material_tables((jt,), device="cpu")
    assert pt.last_parent == (max_levels is None,)
    u, v = _uv(12, e_lo=5.0, e_hi=9.0, base=32.0)
    mat = np.zeros(u.shape, np.int32)
    gj, gp, same = _geometry_pair(jt, pt, mat, u, v)
    assert same.mean() >= 0.999
    deepest = gp["l0"].numpy() == len(pt.heights[0]) - 1
    assert deepest.mean() > 0.9
    frac = gp["frac"].numpy()[deepest]
    if max_levels is None:
        assert (frac > 0).mean() > 0.5
    else:
        assert (frac == 0).all()
    want = jtq.sample_mip_block_pallas(jt, jnp.asarray(mat), jnp.asarray(u),
                                       jnp.asarray(v), TH, TW, interpret=True)
    got = tq.sample_mip_block(pt, _t(mat), _t(u), _t(v), TH, TW)
    for s in got:
        np.testing.assert_allclose(got[s].numpy()[same],
                                   np.asarray(want[s])[same], rtol=3e-7,
                                   atol=3e-7, err_msg=s)


def _shade_inputs(seed):
    # tests/test_shading_pallas.py TestShadeSampledPallas._px and lights.
    rng = np.random.default_rng(seed)
    nt, npx = 10, TH * TW

    def pl(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (nt, npx)).astype(np.float32)

    px = dict(u=pl(-2, 3), v=pl(-2, 3),
              world=(pl(-5, 5), pl(-5, 5), pl(-5, 5)),
              normal=(pl(-1, 1), pl(-1, 1), pl(-1, 1)),
              tangent=(pl(-1, 1), pl(-1, 1), pl(-1, 1)),
              valid=rng.uniform(0, 1, (nt, npx)) > 0.3)
    lights = make_lights([
        dict(type=2, dir=(0.3, -1, 0.5), color=(1, 1, 1), intensity=3.0),
        dict(type=0, pos=(2, 3, -1), color=(1, 0.5, 0.2), intensity=10.0),
        dict(type=1, pos=(0, 5, 0), dir=(0, -1, 0), color=(0.2, 0.8, 1.0),
             intensity=5.0, inner_cutoff=0.9, outer_cutoff=0.5),
    ])
    return px, lights


@pytest.mark.parametrize("uv,nm", [("random", 0), ("smooth", 1)])
def test_shade_mip_groups_matches_pallas_interpret(merged, uv, nm):
    """K2's plain version with a mip-block group and a material-routed
    small group vs ``shade_sampled_pallas`` (interpret) fed
    ``mip_block_prep`` / ``small_prep_multi``
    (tests/test_shading_pallas.py:251-321), at its _assert_close bound;
    random uv (the reference test's) and smooth uv across levels."""
    j, p = merged
    px, lights = _shade_inputs(9)
    if uv == "smooth":
        px["u"], px["v"] = _uv(13, nt=10)
    mat = _mat(9, nt=10)
    vp = np.asarray([0.0, 1.0, -3.0], np.float32)
    ju, jv, jm = jnp.asarray(px["u"]), jnp.asarray(px["v"]), jnp.asarray(mat)
    groups = [jtq.mip_block_prep(j[0], jm, ju, jv, TH, TW),
              jtq.small_prep_multi(j[1], jm, ju, jv)]
    want = shade_sampled_pallas(
        groups, tuple(map(jnp.asarray, px["world"])),
        tuple(map(jnp.asarray, px["normal"])),
        tuple(map(jnp.asarray, px["tangent"])), jnp.asarray(px["valid"]),
        lights, jnp.asarray(vp), jnp.int32(nm), gbuffer_mode=True,
        quantize=True, interpret=True)
    got = shade_sampled(
        p, _t(px["u"]), _t(px["v"]), tuple(map(_t, px["world"])),
        tuple(map(_t, px["normal"])), tuple(map(_t, px["tangent"])),
        _t(px["valid"]), interop.lights(lights, device="cpu"), _t(vp),
        torch.tensor(nm, dtype=torch.int32), mat_id=_t(mat), tile_h=TH,
        tile_w=TW)
    cases.assert_shade_close([np.asarray(w) for w in want],
                             [g.numpy() for g in got])
    # The albedo reaches the frame: material 1 shades differently.
    other = shade_sampled(
        p, _t(px["u"]), _t(px["v"]), tuple(map(_t, px["world"])),
        tuple(map(_t, px["normal"])), tuple(map(_t, px["tangent"])),
        _t(px["valid"]), interop.lights(lights, device="cpu"), _t(vp),
        torch.tensor(nm, dtype=torch.int32), mat_id=_t(1 - mat), tile_h=TH,
        tile_w=TW)
    assert not torch.equal(got[0], other[0])


def test_shade_mip_groups_reference_chain(merged):
    """The same K2 inputs against the reference's XLA chain: mip samplers,
    normal map, fp16 G-buffer, planar GGX (test_mipblock_group's oracle)."""
    from bibim_tpu.ops.shading_planar import shade_pbr_planar

    j, p = merged
    px, lights = _shade_inputs(10)
    px["u"], px["v"] = _uv(14, nt=10)
    mat = _mat(10, nt=10)
    vp = jnp.asarray([0.0, 1.0, -3.0])
    jm = jnp.asarray(mat)
    slots = jtq.sample_material_mips_multi(
        j, jm, jnp.asarray(px["u"]), jnp.asarray(px["v"]), TH, TW,
        use_pallas=False)
    normal = j_normal_map(tuple(map(jnp.asarray, px["normal"])),
                          tuple(map(jnp.asarray, px["tangent"])),
                          (slots["nrm_x"], slots["nrm_y"], slots["nrm_z"]),
                          jnp.int32(0))
    valid = jnp.asarray(px["valid"])

    def mq(x):
        return jnp.where(valid, x, 0.0).astype(jnp.float16).astype(
            jnp.float32)

    want = shade_pbr_planar(
        tuple(mq(jnp.asarray(c)) for c in px["world"]),
        tuple(mq(c) for c in normal),
        tuple(mq(slots[s]) for s in ("alb_r", "alb_g", "alb_b")),
        mq(slots["metallic"]), mq(slots["roughness"]), mq(slots["ao"]),
        lights, vp)
    want = [np.asarray(jnp.where(valid, c, 0.0)) for c in want]
    got = shade_sampled(
        p, _t(px["u"]), _t(px["v"]), tuple(map(_t, px["world"])),
        tuple(map(_t, px["normal"])), tuple(map(_t, px["tangent"])),
        _t(px["valid"]), interop.lights(lights, device="cpu"),
        _t(np.asarray(vp)),
        torch.tensor(0, dtype=torch.int32), mat_id=_t(mat), tile_h=TH,
        tile_w=TW)
    cases.assert_shade_close(want, [g.numpy() for g in got])


def test_mip_wrappers_validate_inputs(merged):
    _, p = merged
    u = torch.zeros((2, TH * TW))
    mat = torch.zeros((2, TH * TW), dtype=torch.int32)
    with pytest.raises(ValueError):  # float material ids
        tq.sample_mip_block_kernel(p[0], mat.float(), u, u)
    with pytest.raises(ValueError):  # rows too short for 41 taps
        tq.sample_mip_block_kernel(
            p[0]._replace(blocks=p[0].blocks[:, :64].contiguous()), mat, u, u)
    with pytest.raises(ValueError):  # not (NT, tile_h·tile_w) planes
        tq.sample_mip_block_kernel(p[0], None, u.reshape(4, -1),
                                   u.reshape(4, -1))
    quad = tq.merge_mip_quad_materials(tuple(
        tq.build_mip_quad_tables(m, device="cpu") for m in _materials()))
    z3 = (u, u, u)
    with pytest.raises(NotImplementedError):  # multi-level quad group
        shade_sampled(quad, u, u, z3, z3, z3, u > 0, interop.lights(
            make_lights([]), device="cpu"), torch.zeros(3), torch.tensor(0),
            mat_id=mat)
