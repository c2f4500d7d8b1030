"""Pair-rate sampling in the port against the JAX package on the CPU: the
escape flags, the group window of K6's and K2's plain versions (and the
anchor the kernels compute, replayed in their thread mapping), the
router's slot partition, the routed, lossy and pair-visibility frames, and
the pair-rate PCF.

A group of 2×1 (level 1) or 2×2 (level 2) pixels reads one block row,
anchored at the min top-left tap of its covered members; tiles where no
covered pixel leaves its group's window sample bit-exactly at the pair
level, so the routed frame equals the per-pixel frame."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.ops.shading_pallas import shade_sampled_pallas
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu.scene.lights import make_lights
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading import shade_sampled
from bibim_tpu_torch.pipeline import framegraph as fg
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import assert_image_bound

TILE_W, NPX = 128, 1024
LEVELS = pytest.mark.parametrize("pair", [1, 2], ids=["pairs", "quads"])


def _tables(seed=21, size=64):
    """One 64² block table (metallic) in both packages."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 1), np.uint8)
    (jt,) = jtq.build_quad_tables({"metallic": img}, block_threshold=1024)
    (pt,) = interop.material_tables((jt,), device="cpu")
    assert isinstance(pt, tq.BlockTable)
    return jt, pt


def _uv_mixed(nt=6, h=64, w=64, seed=9):
    """tests/test_sample_route.py's stream, unwrapped so that uv crosses 0
    and 1 (REPEAT addressing): the first nt // 2 tiles constant within
    every 2×2 group (provably clean), the rest minified noise."""
    rng = np.random.default_rng(seed)
    rho = np.linspace(0.4, 4.0, nt)[:, None, None]
    x = np.arange(TILE_W)[None, None, :] + rng.uniform(0, 0.3,
                                                       (nt, 8, TILE_W))
    y = (np.arange(8)[None, :, None] + rng.uniform(0, 0.3, (nt, 8, TILE_W))
         + 16 * np.arange(nt)[:, None, None])
    u = x * rho / w - 0.3
    v = y * rho / h - 0.45
    nc = nt // 2
    for p in (u, v):
        g = p[:nc].reshape(nc, 4, 2, 64, 2)
        g[:] = g[:, :, :1, :, :1]
    assert (u < 0).any() and (u > 1).any() and (v < 0).any()
    return u.reshape(nt, -1).astype(np.float32), \
        v.reshape(nt, -1).astype(np.float32)


def _valid(shape, seed=3, dead_groups=True):
    """Random coverage; with ``dead_groups``, every 2×2 group of a band of
    rows in each tile uncovered."""
    rng = np.random.default_rng(seed)
    valid = rng.random(shape) > 0.15
    if dead_groups:
        v = valid.reshape(shape[0], 8, TILE_W)
        v[:, 2:4, 40:80] = False
    return valid


@LEVELS
@pytest.mark.parametrize("dead", [False, True], ids=["random", "dead_groups"])
def test_escape_tiles_match_jax(pair, dead):
    jt, pt = _tables()
    u, v = _uv_mixed()
    valid = _valid(u.shape, dead_groups=dead)
    want = np.asarray(jtq.escape_tiles(jt, jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(valid), pair))
    got = tq.escape_tiles(pt, cases.t(u), cases.t(v), cases.t(valid), pair)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()  # the stream splits the tiles
    hw = tq.escape_tiles_hw(pt.height, pt.width, cases.t(u), cases.t(v),
                            cases.t(valid), pair)
    np.testing.assert_array_equal(hw.numpy(), want)
    none = tq.escape_tiles(pt, cases.t(u), cases.t(v),
                           torch.zeros(u.shape, dtype=torch.bool), pair)
    assert not none.any()  # uncovered pixels never escape


@LEVELS
def test_group_constant_stream_is_all_clean(pair):
    jt, pt = _tables()
    u, v = _uv_mixed(nt=4)
    u, v = u[:2], v[:2]
    valid = np.ones(u.shape, bool)
    assert not tq.escape_tiles(pt, cases.t(u), cases.t(v), cases.t(valid),
                               pair).any()
    assert not np.asarray(jtq.escape_tiles(
        jt, jnp.asarray(u), jnp.asarray(v), jnp.asarray(valid), pair)).any()


@LEVELS
def test_group_window_matches_block_prep(pair):
    """The per-pixel row, window-relative taps and clamped fractions equal
    the JAX package's ``block_prep(pair_rows=)`` planes (pixel layout,
    rows expanded to pixel rate)."""
    jt, pt = _tables()
    u, v = _uv_mixed()
    valid = _valid(u.shape)
    prep = jtq.block_prep(jt, jnp.asarray(u), jnp.asarray(v),
                          pair_rows=pair, valid=jnp.asarray(valid),
                          tile_w=TILE_W, layout="pixel")
    row, lx, ly, tx, ty = tq._block_taps(pt, cases.t(u), cases.t(v), pair,
                                         cases.t(valid), TILE_W)
    for got, key in ((lx, "lx"), (ly, "ly"), (tx, "tx"), (ty, "ty")):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(prep[key]).reshape(-1), key)
    rows = pt.blocks[row.long()].numpy()  # (N, row bytes)
    want = np.transpose(np.asarray(prep["qt"]), (0, 2, 1)).reshape(
        rows.shape)
    np.testing.assert_array_equal(rows, want)
    clamped = ((lx == 0) & (tx == 0)) | ((lx == 3) & (tx == 1))
    assert clamped.any()


@LEVELS
def test_block_sampler_matches_jax(pair):
    """K6's plain version at pair rate against ``sample_table_block_pallas``
    (interpret; member layout at level 2), and at level 1 against the JAX
    package's XLA sampler at this level, which hands ``block_prep``
    ``pair_rows=True`` and so samples 2×1 pairs at level 2 too: the
    reference test's 3e-7 bound (XLA:CPU fuses the blend's FMAs)."""
    jt, pt = _tables()
    u, v = _uv_mixed()
    valid = _valid(u.shape)
    ju, jv, jval = jnp.asarray(u), jnp.asarray(v), jnp.asarray(valid)
    got = tq.sample_table_block_kernel(pt, cases.t(u), cases.t(v),
                                       pair_rows=pair, valid=cases.t(valid))
    exact = tq.sample_table_block(pt, cases.t(u), cases.t(v))
    xla = jtq.sample_table_block(jt, ju, jv, pair_rows=pair, valid=jval)
    pairs = tq.sample_table_block(pt, cases.t(u), cases.t(v), 1,
                                  cases.t(valid))
    for g, want in ((got, jtq.sample_table_block_pallas(
            jt, ju, jv, interpret=True, pair_rows=pair, valid=jval)),
                    (pairs, xla)):
        np.testing.assert_allclose(g["metallic"].numpy(),
                                   np.asarray(want["metallic"]), rtol=3e-7,
                                   atol=3e-7)
    # Clean tiles sample bit-exactly, escaping ones not.
    esc = tq.escape_tiles(pt, cases.t(u), cases.t(v), cases.t(valid),
                          pair).numpy()
    g, e = got["metallic"].numpy(), exact["metallic"].numpy()
    np.testing.assert_array_equal(np.where(valid, g, 0)[~esc],
                                  np.where(valid, e, 0)[~esc])
    assert ((g != e) & valid)[esc].any()


def _lights():
    return make_lights([
        dict(type=2, dir=(0.3, -1, 0.5), color=(1, 1, 1), intensity=3.0),
        dict(type=0, pos=(2, 3, -1), color=(1, 0.5, 0.2), intensity=10.0),
    ])


@LEVELS
def test_shade_pair_matches_pallas_interpret(pair):
    """K2's plain version at a pair level against
    ``shade_sampled_pallas`` (interpret) fed as the JAX frame feeds it
    (``_sampled_hdr_pass``: member-major planes and the member layout's
    rep-rate rows at level 2, the pixel layout at level 1), unpermuted."""
    maps = cases.material_maps(4)
    jtabs = jtq.build_quad_tables(maps, block_threshold=1024)
    u, v = _uv_mixed(nt=4)
    rng = np.random.default_rng(pair)

    def p(lo, hi):
        return rng.uniform(lo, hi, u.shape).astype(np.float32)

    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    tangent = (p(-1, 1), p(-1, 1), p(-1, 1))
    valid = _valid(u.shape, seed=pair)
    member = pair >= 2
    ry, rx = jtq.pair_factors(pair)

    def perm(x):
        x = jnp.asarray(x)
        return jtq.member_perm(x, ry, rx, TILE_W) if member else x

    groups = []
    for t in jtabs:
        if isinstance(t, jtq.BlockTable):
            groups.append(jtq.block_prep(
                t, jnp.asarray(u), jnp.asarray(v), pair_rows=pair,
                valid=jnp.asarray(valid), tile_w=TILE_W,
                layout="member" if member else "pixel"))
        else:
            groups.append(jtq.small_prep(t, perm(u), perm(v)))
    lights = _lights()
    vp = (0.0, 1.0, -3.0)
    hdr = shade_sampled_pallas(
        groups, tuple(map(perm, world)), tuple(map(perm, normal)),
        tuple(map(perm, tangent)), perm(valid), lights, jnp.asarray(vp),
        jnp.int32(1), interpret=True)
    want = [np.asarray(jtq.member_unperm(c, ry, rx, TILE_W) if member
                       else c) for c in hdr]
    got = shade_sampled(
        interop.material_tables(jtabs, device="cpu"), cases.t(u),
        cases.t(v), tuple(map(cases.t, world)),
        tuple(map(cases.t, normal)), tuple(map(cases.t, tangent)),
        cases.t(valid), interop.lights(lights, device="cpu"),
        torch.tensor(vp), torch.tensor(1, dtype=torch.int32), pair=pair)
    cases.assert_shade_close(want, [g.numpy() for g in got])


def _pair_pixel(f, tile_w, pair):
    """csrc/shading.cuh ``pair_pixel``: the pixel thread ``f`` of a
    warp-aligned launch samples at a pair level. Within each chunk of
    2·tile_w indices (a tile's row pair) warp k takes columns [16k,
    16k+16) of both rows: at level 2 lanes 4m..4m+3 are 2×2 group m (lane
    bit 0 the column, bit 1 the row), at level 1 lanes 2m, 2m+1 are 2×1
    group m (bit 0 the row)."""
    c0 = f - f % (2 * tile_w)
    lane = f & 31
    warp_col = (f - c0) >> 5 << 4
    if pair == 2:
        col, row = warp_col + ((lane >> 2) << 1 | (lane & 1)), (lane >> 1) & 1
    else:
        col, row = warp_col + (lane >> 1), lane & 1
    return c0 + row * tile_w + col


def _kernel_anchor(u, v, valid, h, w, pair, tile_w=TILE_W,
                   all_members=True):
    """The kernels' group anchor replayed as tensor ops in their warp
    mapping (csrc/shading.cuh ``pair_pixel``, ``group_anchor``,
    ``covered_anchor``, ``window_tap``): thread f samples pixel
    ``_pair_pixel(f)`` and computes that pixel's footprint once (C's
    truncating int conversion and remainder fix-up). K6 (``all_members``)
    reduces its covered top-left tap and its tap over the lanes f ^ 1
    (and f ^ 2 at level 2) with a min, every lane taking part; a group
    with no covered member anchors at the all-member min. In K2 only the
    covered lanes take part: each reads the taps of its group's covered
    members (lanes f ^ k, k < 2·rx) straight from their lanes. Returns
    flat (row, lx, ly, tx, ty) in pixel order."""
    uf, vf, vb = u.reshape(-1), v.reshape(-1), valid.reshape(-1)
    f = torch.arange(uf.numel())
    i = _pair_pixel(f, tile_w, pair)
    assert torch.equal(i.sort().values, f)

    def footprint(uu, vv):
        fx = uu * w - 0.5
        fy = vv * h - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        xi = torch.fmod(x0.to(torch.int32), w)
        yi = torch.fmod(y0.to(torch.int32), h)
        return (torch.where(xi < 0, xi + w, xi),
                torch.where(yi < 0, yi + h, yi), fx - x0, fy - y0)

    x0i, y0i, tx, ty = footprint(uf[i], vf[i])
    cov = vb[i]
    big = torch.full_like(x0i, 1 << 30)
    if all_members:
        cx, cy = torch.where(cov, x0i, big), torch.where(cov, y0i, big)
        ax, ay = x0i, y0i
        for s in (1, 2) if pair == 2 else (1,):
            cx, cy = (torch.minimum(cx, cx[f ^ s]),
                      torch.minimum(cy, cy[f ^ s]))
            ax, ay = (torch.minimum(ax, ax[f ^ s]),
                      torch.minimum(ay, ay[f ^ s]))
        any_cov = cx != big
    else:
        cx, cy = x0i, y0i
        for k in range(1, 4 if pair == 2 else 2):
            take = cov[f ^ k]
            cx = torch.where(take, torch.minimum(cx, x0i[f ^ k]), cx)
            cy = torch.where(take, torch.minimum(cy, y0i[f ^ k]), cy)
        ax, ay, any_cov = cx, cy, cov
    bx = torch.where(any_cov, cx, ax) // 4
    by = torch.where(any_cov, cy, ay) // 4
    cx = torch.remainder(x0i - bx * 4 + w // 2, w) - w // 2
    cy = torch.remainder(y0i - by * 4 + h // 2, h) - h // 2

    def frac(cc, fr):
        out = torch.where(cc < 0, torch.zeros_like(fr), torch.ones_like(fr))
        return torch.where((cc < 0) | (cc > 3), out, fr)

    lanes = (by * (w // 4) + bx, cx.clamp(0, 3), cy.clamp(0, 3),
             frac(cx, tx), frac(cy, ty))
    pixels = []
    for x in lanes:
        out = torch.empty_like(x)
        out[i] = x
        pixels.append(out)
    return tuple(pixels)


@LEVELS
@pytest.mark.parametrize("garbage", [False, True],
                         ids=["finite", "nan_at_misses"])
def test_kernel_anchor_replay_matches_plain(pair, garbage):
    """The anchor K2 and K6 compute over a group's lanes equals the plain
    version's group window: K6's (every member's tap offered) at every
    pixel for finite uv (K6 samples misses too), K2's (covered members
    only) and K6's at covered pixels with NaN uv at the misses."""
    _, pt = _tables()
    u, v = (cases.t(x) for x in _uv_mixed())
    valid = cases.t(_valid(tuple(u.shape)))
    if garbage:
        u = torch.where(valid, u, torch.full_like(u, float("nan")))
        v = torch.where(valid, v, torch.full_like(v, float("nan")))
    want = tq._block_taps(pt, u, v, pair, valid, TILE_W)
    covered = valid.reshape(-1)
    for all_members, keep in ((True, covered if garbage
                               else torch.ones_like(covered)),
                              (False, covered)):
        got = _kernel_anchor(u, v, valid, pt.height, pt.width, pair,
                             all_members=all_members)
        for g, w, name in zip(got, want, ("row", "lx", "ly", "tx", "ty")):
            assert torch.equal(g[keep], w[keep].to(g.dtype)), (name,
                                                              all_members)


@LEVELS
@pytest.mark.parametrize("tile_w", [16, 32, 128])
def test_pair_pixel_permutes_each_chunk(pair, tile_w):
    """``pair_pixel`` is a bijection on every chunk of 2·tile_w flat
    indices, holds each 2×1 / 2×2 group in the lanes the anchor's
    shuffles reach (f ^ 1, f ^ 2 in one warp) and has each warp write
    two runs of 16 adjacent pixels, one a row (64-byte segments)."""
    nt, tile_h = 3, 8
    n = nt * tile_h * tile_w
    f = torch.arange(n)
    i = _pair_pixel(f, tile_w, pair)
    chunk = 2 * tile_w
    assert torch.equal(i // chunk, f // chunk)
    assert torch.equal(i.sort().values, f)
    row, col = (i % (tile_h * tile_w)) // tile_w, i % tile_w
    group = (i // (tile_h * tile_w), row // 2,
             col // 2 if pair == 2 else col)
    for s in (1, 2) if pair == 2 else (1,):
        for a, b in zip(group, group):
            assert torch.equal(a, b[f ^ s])
    warp = i.reshape(-1, 32).sort().values.reshape(-1, 2, 16)  # 2 rows
    assert torch.equal(warp - warp[:, :, :1],
                       torch.arange(16).expand_as(warp))
    assert torch.equal(warp[:, 1, 0] - warp[:, 0, 0],
                       torch.full_like(warp[:, 0, 0], tile_w))


def _partition_jax(flags, q_cap, e_cap):
    """tests/test_sample_route.py's replica of the JAX router's
    partition."""
    nt = flags.shape[0]
    flags = jnp.asarray(flags)
    clean = ~flags
    rank = jnp.cumsum(clean.astype(jnp.int32)) - 1
    over_q = clean & (rank >= q_cap)
    clean_ids, _ = jfg._compact_ids(clean & ~over_q, q_cap, nt)
    esc_ids, esc_over = jfg._compact_ids(flags | over_q, e_cap, nt)
    return np.asarray(clean_ids), np.asarray(esc_ids), int(esc_over)


@pytest.mark.parametrize("flags,q_cap,e_cap,over", [
    (np.random.default_rng(11).random(37) < 0.4, 40, 40, 0),
    (np.zeros(16, bool), 10, 16, 0),  # clean overflow runs exact
    (np.ones(16, bool), 16, 10, 6),  # exact overflow is counted
    (np.random.default_rng(12).random(29) < 0.5, 9, 12, 8),
], ids=["random", "clean_overflow", "exact_overflow", "both"])
def test_route_partition_matches_jax(flags, q_cap, e_cap, over):
    nt = flags.shape[0]
    q_ids, e_ids, e_over = fg._route_slots(torch.as_tensor(flags), q_cap,
                                           e_cap)
    wq, we, wover = _partition_jax(flags, q_cap, e_cap)
    np.testing.assert_array_equal(q_ids.numpy(), wq)
    np.testing.assert_array_equal(e_ids.numpy(), we)
    assert int(e_over) == wover == over
    real = np.concatenate([q_ids[q_ids < nt], e_ids[e_ids < nt]])
    assert len(real) == nt - over
    assert len(set(real.tolist())) == len(real)  # each slot at most once
    assert not flags[q_ids[q_ids < nt].numpy()].any()  # clean pass clean


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    return cases.frame_inputs()


def _jax_image(inputs, **kw):
    jin, _ = inputs
    return np.asarray(jfg.render_frame(
        *jin, jfg.RenderSettings(outputs="image", **cases.FRAME_BASE,
                                 **kw))["image"])


@pytest.fixture(scope="module")
def exact(inputs):
    """The per-pixel frame: the JAX package's image (its CPU frame samples
    per pixel whatever pair_sampling asks, as the routed frame must) and
    the port's production image at pair level 0."""
    return (_jax_image(inputs, pair_sampling=2),
            cases.port_frame(inputs, outputs="image")["image"])


@pytest.fixture(scope="module")
def routed_without_fma():
    """The JAX frame without FMAs beside the port's routed frame at level
    2 (cases.frames_without_fma)."""
    ref, (port,) = cases.frames_without_fma(
        "frame", dict(pair_sampling=2),
        [dict(outputs="image", pair_sampling=2)])
    return ref, port


@LEVELS
def test_routed_frame_equals_exact_frame(inputs, exact, routed_without_fma,
                                         pair):
    """The routed production frame (clean tiles at the pair level, the
    rest per pixel) is the pair-0 frame bit for bit, with the clean list
    overflowing into the exact pass or not; an undersized exact pass is
    reported."""
    jax_img, pair0 = exact
    _, (pscene, pvb, _, pmats, _) = inputs
    px, _, _, _ = fg._assemble_and_raster(
        pscene, pvb, fg.RenderSettings(**cases.FRAME_BASE), fg.KERNELS)
    flags = fg._escape_flags(pmats, px, pair, TILE_W)
    n_esc, nt = int(flags.sum()), flags.shape[0]
    assert 0 < n_esc < nt  # both passes run
    for caps in ((nt, nt), (max(nt - n_esc - 3, 1), nt)):
        out = cases.port_frame(inputs, outputs="image+diag",
                               pair_sampling=pair, sample_route_caps=caps)
        check_bin_diag(out["bin_diag"])
        assert torch.equal(out["image"], pair0)
    # 0.1068 % of pixels differ by one LSB (measured; the production
    # frame of tests/test_torch_frame.py): XLA:CPU's FMA differences
    # across RGBA16F rounding boundaries, held against the JAX frame
    # without FMAs.
    assert_image_bound(pair0.numpy(), jax_img, 1.1e-3)
    ref, port = routed_without_fma
    np.testing.assert_array_equal(port["image"], pair0.numpy())
    cases.assert_rounding_crossings(port, ref, hdr_steps=4)
    short = cases.port_frame(inputs, outputs="image+diag",
                             pair_sampling=pair,
                             sample_route_caps=(nt, n_esc - 2))
    assert int(short["bin_diag"].dropped_tiles) == 2


def test_full_frame_reports_route_caps_like_jax(inputs):
    """An "full" frame shades through the plain chain but reports the
    production router's overflow as the JAX package's frame does."""
    jin, _ = inputs
    kw = dict(pair_sampling=2, sample_route_caps=(4, 20))
    want = jfg.render_frame(*jin, jfg.RenderSettings(
        outputs="full", **cases.FRAME_BASE, **kw))["bin_diag"]
    got = cases.port_frame(inputs, outputs="full", **kw)["bin_diag"]
    assert int(got.dropped_tiles) == int(want.dropped_tiles) > 0


def _pallas_block_sampler(table, u, v, pair_rows=False, valid=None,
                          tile_w=128):
    """The JAX frame's XLA block sampler replaced by the TPU kernel the
    port ported (interpret mode), which samples 2×2 quads at level 2."""
    return jtq.sample_table_block_pallas(table, u, v, interpret=True,
                                         pair_rows=pair_rows, valid=valid,
                                         tile_w=tile_w)


@pytest.mark.parametrize("kw", [
    dict(pair_sampling=1, pair_lossy=True),
    dict(pair_sampling=2, pair_lossy=True),
    dict(pair_sampling=2, pair_lossy=True, enable_ibl=True),
    dict(cases.SHADOWS, pair_visibility=True),
], ids=["lossy_pairs", "lossy_quads", "lossy_gbuffer", "pair_visibility"])
def test_lossy_frames_match_jax(inputs, kw, monkeypatch):
    """The lossy modes against the JAX package's frame on its XLA path:
    ``pair_lossy`` samples the block tables at the pair level everywhere
    (K2's pair path; with IBL, the G-buffer path's K6), pair_visibility
    reads the PCF at pair rate; both the plain "full" chain and the
    production path, and the lossy frame is not the exact one. At level 2
    the JAX frame samples its block table through
    ``sample_table_block_pallas`` in interpret mode: its XLA sampler
    samples pairs there (test_block_sampler_matches_jax)."""
    from bibim_tpu.ops import ibl as jibl

    jin, _ = inputs
    if kw.get("pair_sampling") == 2:
        monkeypatch.setattr(jtq, "sample_table_block", _pallas_block_sampler)
    probe = jibl.make_ibl_sh() if kw.get("enable_ibl") else None
    want = np.asarray(jfg.render_frame(
        *jin, jfg.RenderSettings(outputs="image", **cases.FRAME_BASE, **kw),
        ibl=probe)["image"])
    pibl = None if probe is None else interop.ibl(probe, device="cpu")
    # Level 1: 0.1038 % ("full") and 0.1068 % (production) of pixels
    # differ by one LSB (measured; the exact frame's fractions): XLA:CPU's
    # FMA differences across RGBA16F rounding boundaries, held below
    # against the JAX frame without FMAs. The others: at most 0.0977 %.
    frac = 1.1e-3 if kw.get("pair_sampling") == 1 else 1e-3
    for outputs in ("full", "image"):
        got = cases.port_frame(inputs, ibl=pibl, outputs=outputs, **kw)
        assert_image_bound(got["image"].numpy(), want, frac)
    if frac > 1e-3:
        ref, (full, prod) = cases.frames_without_fma(
            "frame", kw, [dict(outputs="full", **kw),
                          dict(outputs="image", **kw)])
        cases.assert_rounding_crossings(full, ref)
        cases.assert_rounding_crossings(prod, ref, hdr_steps=4)
    if not kw.get("enable_ibl"):
        ref = cases.port_frame(inputs, outputs="image", **dict(
            kw, pair_lossy=False, pair_visibility=False))
        assert not torch.equal(got["image"], ref["image"])


def test_pair_pcf_matches_jax():
    """``shadow_factor_compact(pair=True)`` with the cap at and below the
    tile count."""
    from bibim_tpu.ops import shadow as jsh
    from bibim_tpu_torch.ops import shadow as sh

    rng = np.random.default_rng(8)
    size, nt = 64, 8
    lvp = jsh.light_view_proj(jnp.asarray([0.2, -1.0, 0.3]),
                              jnp.asarray([-5.0, -5.0, -5.0]),
                              jnp.asarray([5.0, 5.0, 5.0]))
    depth = rng.uniform(0, 1, (size, size)).astype(np.float32)
    jmap = jsh.build_shadow_map(jnp.asarray(depth), lvp, size)
    pmap = sh.build_shadow_map(cases.t(depth), cases.t(lvp), size)
    world = tuple(rng.uniform(-8, 8, (nt, NPX)).astype(np.float32)
                  for _ in range(3))
    valid = rng.random((nt, NPX)) > 0.3
    valid[:2] = False
    for cap in (nt, 12, 3):
        want, wdrop = jsh.shadow_factor_compact(
            jmap, tuple(map(jnp.asarray, world)), jnp.asarray(valid), cap,
            2e-3, pair=True)
        got, drop = sh.shadow_factor_compact(
            pmap, tuple(map(cases.t, world)), cases.t(valid), cap, 2e-3,
            pair=True)
        assert int(drop) == int(wdrop)
        diff = np.abs(got.numpy() - np.asarray(want))
        assert (diff > 1e-4).mean() < 1e-3, diff.max()
    assert int(drop) > 0
    # Partners share the representative's value inside the frustum.
    g = got.numpy().reshape(nt, 4, 2, TILE_W)
    assert (g[:, :, 0] == g[:, :, 1]).mean() > 0.5


def test_settings_pass_check_supported(inputs):
    _, (_, _, _, pmats, _) = inputs
    for kw in (dict(pair_sampling=1), dict(pair_sampling=2, pair_lossy=True),
               dict(pair_visibility=True, enable_shadows=True)):
        fg.check_supported(fg.RenderSettings(**kw), pmats)
    with pytest.raises(NotImplementedError):
        fg.check_supported(fg.RenderSettings(pair_sampling=3), pmats)
    s = dataclasses.replace(fg.RenderSettings(pair_sampling=2),
                            pair_lossy=True)
    assert not fg._routes(pmats, s) and fg._routes(
        pmats, fg.RenderSettings(pair_sampling=2))
