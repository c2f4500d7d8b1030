"""K8's per-pixel geometry (csrc/mip_sample.cu, shading.cuh
``mip_geometry``) replayed as tensor ops in the kernel's thread mapping:
a warp covers 2 rows × 16 columns of a tile, a pixel's quad partners are
lanes ``lane ^ 1`` and ``lane ^ 16`` (taken here by index arithmetic), the
per-material numbers come from ``texture_quad.mip_level_table`` by index
(sizes as the float32 bits it stores), and the floor-mods are C's
truncating ``%`` plus the divisor where negative.

The replay must equal ``texture_quad._mip_block_geometry`` (what the plain
versions and K2 compute) bit for bit in every plane, and the JAX package's
``_mip_block_geometry`` within tests/test_torch_mips.py's bounds (integer
planes equal except where log2(rho) lies within 1e-5 of an integer, where
XLA:CPU's FMA contraction or its log2 may pick the neighbouring level;
fractions within 2 ulps, frac within 5e-7). Cases: negative uv and uv
past 1 (REPEAT), ids out of range both ways, two materials with different
level counts (one a true last level, ``last_parent`` false), LODs on
exact integers and 1-4 float steps beside them
(``chip_smoke.mip_rho_stress``), and no id plane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import texture_quad as tq
from tests import torch_port_cases as cases
from tests.test_torch_mips import _alb, _uv

TH, TW = 8, 128
NT = 24
PLANES = tq.MIP_INT_PLANES + tq.MIP_FLOAT_PLANES + ("l0",)


def _fmod_floor(a, b):
    """C's a % b (truncating), then + b where negative: torch.remainder
    for b > 0."""
    r = torch.fmod(a, b)
    return torch.where(r < 0, r + b, r)


def kernel_geometry(table, mat_id, u, v, tile_h: int = TH,
                    tile_w: int = TW) -> dict:
    """The planes K8's threads compute, in (NT, tile_h·tile_w) order."""
    ints, nlev = tq.mip_level_table(table)
    mt = torch.tensor(ints, dtype=torch.int32)
    nmat = len(table.heights)
    nt, npx = u.shape
    segs = tile_w // 16
    per_tile = tile_h // 2 * segs
    wid = torch.arange(nt * per_tile)[:, None]
    lane = torch.arange(32)[None, :]
    tile, r = wid // per_tile, wid % per_tile
    rp = r // segs
    i = (tile * npx + (2 * rp + lane // 16) * tile_w
         + 16 * (r - rp * segs) + lane % 16)  # (warps, 32) pixel index
    uf, vf = u.reshape(-1)[i], v.reshape(-1)[i]
    m = (torch.zeros_like(i, dtype=torch.int32) if mat_id is None
         else mat_id.reshape(-1)[i])

    def partner(x, mask):
        return x[:, lane[0] ^ mask]

    right, bottom = (lane & 1) == 1, (lane & 16) == 16
    ux, vx, uy, vy = (partner(uf, 1), partner(vf, 1), partner(uf, 16),
                      partner(vf, 16))
    du_dx = torch.where(right, uf - ux, ux - uf)
    dv_dx = torch.where(right, vf - vx, vx - vf)
    du_dy = torch.where(bottom, uf - uy, uy - uf)
    dv_dy = torch.where(bottom, vf - vy, vy - vf)

    ok = (m >= 0) & (m < nmat)
    head = 4 * torch.where(ok, m, torch.zeros_like(m)).long()
    mf = mt.view(torch.float32)  # the words that hold float32 bits
    h0, w0 = mf[head], mf[head + 1]
    max_level, no_parent = mt[head + 2], mt[head + 3] != 0
    ax, bx = du_dx * w0, dv_dx * h0
    ay, by = du_dy * w0, dv_dy * h0
    rho_x = torch.sqrt(ax * ax + bx * bx)
    rho_y = torch.sqrt(ay * ay + by * by)
    lod = torch.clamp(torch.log2(torch.clamp(torch.maximum(rho_x, rho_y),
                                             min=1e-12)), min=0.0)
    l0 = torch.minimum(torch.clamp(torch.floor(lod).to(torch.int32), min=0),
                       max_level)
    frac = torch.where((l0 == max_level) & no_parent, torch.zeros_like(lod),
                       torch.clamp(lod - l0.float(), 0.0, 1.0))
    lv = (4 * nmat + 8 * (torch.where(ok, m, torch.zeros_like(m)) * nlev
                          + l0)).long()

    def level(words, k, default):
        return torch.where(ok, words[lv + k],
                           torch.full_like(words[lv + k], default))

    hi, wi, off, nbx = (level(mt, 0, 1), level(mt, 1, 1), level(mt, 2, 0),
                        level(mt, 3, 1))
    hf, wf, h2f, w2f = (level(mf, k, 1.0) for k in range(4, 8))
    fx, fy = uf * wf - 0.5, vf * hf - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x0i = _fmod_floor(x0.to(torch.int32), wi)
    y0i = _fmod_floor(y0.to(torch.int32), hi)
    bxi = torch.div(x0i, 4, rounding_mode="trunc")
    byi = torch.div(y0i, 4, rounding_mode="trunc")
    w2i = torch.clamp(torch.div(wi, 2, rounding_mode="trunc"), min=1)
    h2i = torch.clamp(torch.div(hi, 2, rounding_mode="trunc"), min=1)
    fx2, fy2 = uf * w2f - 0.5, vf * h2f - 0.5
    x02, y02 = torch.floor(fx2), torch.floor(fy2)
    g = {"idx": off + byi * nbx + bxi, "lx": x0i - bxi * 4,
         "ly": y0i - byi * 4,
         "pxi": _fmod_floor(x02.to(torch.int32) - (2 * bxi - 1), w2i),
         "pyi": _fmod_floor(y02.to(torch.int32) - (2 * byi - 1), h2i),
         "tx": fx - x0, "ty": fy - y0, "tx2": fx2 - x02, "ty2": fy2 - y02,
         "frac": frac, "l0": l0, "lod": lod}
    order = i.reshape(-1).argsort()
    return {k: x.reshape(-1)[order].reshape(nt, npx) for k, x in g.items()}


@pytest.fixture(scope="module")
def merged():
    """(JAX merged block binding, the same carried into the port): a 32²
    pyramid (4 levels, its last parent stored) and a 64² one cut at 3
    levels (a true last level)."""
    cases.cap_threads()
    j = jtq.merge_mip_block_materials(tuple(
        jtq.build_mip_block_tables(_alb(seed, base, ml))
        for seed, base, ml in ((1, 32, None), (2, 64, 3))))
    return j, interop.material_tables(j, device="cpu")


def _inputs(table, case: str):
    if case == "rho_stress":
        return chip_smoke.mip_rho_stress(table, NT, "cpu")
    u, v = _uv(5, nt=NT, e_lo=-3.0, e_hi=7.0, base=48.0)
    if case == "no_ids":
        return None, cases.t(u), cases.t(v)
    mat = np.random.default_rng(5).integers(-2, 4, u.shape).astype(np.int32)
    return cases.t(mat), cases.t(u), cases.t(v)


CASES = ["edges", "rho_stress", "no_ids"]


@pytest.mark.parametrize("case", CASES)
def test_replay_equals_torch_geometry(merged, case):
    """Every plane bit for bit; the case reaches what it is for."""
    table = merged[1][0]
    assert table.last_parent == (True, False)
    assert len({len(h) for h in table.heights}) == 2
    mat, u, v = _inputs(table, case)
    want = tq._mip_block_geometry(table, mat, u, v, TH, TW)
    got = kernel_geometry(table, mat, u, v)
    for k in PLANES:
        assert torch.equal(got[k], want[k]), k
    l0 = want["l0"]
    if mat is not None:
        out = (mat < 0) | (mat >= len(table.heights))
        assert bool(out.any()) and bool((mat == 1).any())
        assert bool((want["idx"][out] <= 0).all())  # h = w = 1: row off 0
        # material 1's last level (a true one): frac forced to 0
        last1 = (mat == 1) & (l0 == len(table.heights[1]) - 1)
        assert bool(last1.any()) and bool((want["frac"][last1] == 0).all())
    if case == "rho_stress":
        lod_int = want["frac"] == 0
        assert bool(lod_int.any()) and bool((~lod_int).any())
        assert bool((u < 0).any()) and bool((v < 0).any())
    else:
        assert bool((u < 0).any()) and bool((u > 1).any())
    assert len(l0.unique()) >= 4


@pytest.mark.parametrize("case", CASES)
def test_replay_matches_jax_geometry(merged, case):
    j, p = merged
    mat, u, v = _inputs(p[0], case)
    got = kernel_geometry(p[0], mat, u, v)
    # No id plane is material 0 in the port; the JAX package's where-chain
    # is handed the zeros plane that means.
    jmat = np.zeros(u.shape, np.int32) if mat is None else mat.numpy()
    gj = jtq._mip_block_geometry(j[0], jnp.asarray(jmat),
                                 jnp.asarray(u.numpy()),
                                 jnp.asarray(v.numpy()), TH, TW)
    same = np.ones(u.shape, bool)
    for k in tq.MIP_INT_PLANES:
        same &= np.asarray(gj[k]) == got[k].numpy()
    lod = got["lod"].numpy()
    assert same.mean() >= 0.999
    assert (np.abs(lod - np.round(lod))[~same] < 1e-5).all()
    for k in ("tx", "ty", "tx2", "ty2"):
        assert cases.ulps(got[k].numpy()[same],
                          np.asarray(gj[k])[same]).max() <= 2, k
    np.testing.assert_allclose(got["frac"].numpy()[same],
                               np.asarray(gj["frac"])[same], rtol=0,
                               atol=5e-7)
