"""The port's image-based lighting (bibim_tpu_torch.ops.ibl) vs the JAX
package's ops/ibl on the CPU: the bind-time numpy products (equal), the
analytic and table ambient (few-ulp float math, the table path through
the K7 plain version), and interop of the JAX package's probes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import ibl as jibl
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import ibl
from bibim_tpu_torch.pipeline import KERNELS, PLAIN
from tests import torch_port_cases as cases


@pytest.fixture(scope="module")
def probes():
    cases.cap_threads()
    return (jibl.make_ibl_sh(), ibl.make_ibl_sh(device="cpu"),
            jibl.make_ibl(), ibl.make_ibl(device="cpu"))


def test_bind_time_products_equal():
    np.testing.assert_array_equal(ibl.make_procedural_sky(),
                                  jibl.make_procedural_sky())
    env = ibl.make_procedural_sky(16, 32)
    np.testing.assert_array_equal(ibl._convolve(env, 8, 16, 6.0),
                                  jibl._convolve(env, 8, 16, 6.0))


def test_make_ibl_sh_equal(probes):
    jsh, psh, _, _ = probes
    for name in ("irradiance", "spec_gloss", "spec_rough"):
        j, p = getattr(jsh, name), getattr(psh, name)
        assert p.degree == j.degree
        for f in ("coef", "sg_axis", "sg_amp", "sg_sharp"):
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
    irr = ibl._convolve(ibl.make_procedural_sky(), 16, 32, power=1.0)
    assert ibl.sph_poly_error(psh.irradiance, irr) == \
        jibl.sph_poly_error(jsh.irradiance, irr)


def test_make_ibl_tables_equal(probes):
    _, _, jmaps, pmaps = probes
    assert pmaps.hdr_scale == jmaps.hdr_scale
    for name in ("irradiance", "spec_gloss", "spec_rough"):
        for p, j in zip(getattr(pmaps, name), interop.material_tables(
                getattr(jmaps, name), device="cpu")):
            assert (p.height, p.width, p.present) == (j.height, j.width,
                                                      j.present)
            assert torch.equal(p.quads, j.quads)


def test_interop_ibl(probes):
    jsh, psh, jmaps, pmaps = probes
    conv = interop.ibl(jsh, device="cpu")
    for name in ("irradiance", "spec_gloss", "spec_rough"):
        for f in ("coef", "sg_axis", "sg_amp", "sg_sharp"):
            assert torch.equal(getattr(getattr(conv, name), f),
                               getattr(getattr(psh, name), f))
    conv = interop.ibl(jmaps, device="cpu")
    assert isinstance(conv, ibl.IblMaps)
    assert conv.hdr_scale == pmaps.hdr_scale
    assert torch.equal(conv.spec_gloss[0].quads, pmaps.spec_gloss[0].quads)
    with pytest.raises(NotImplementedError):
        interop.ibl(object(), device="cpu")


def _shading(seed, shape=(4, 1024)):
    rng = np.random.default_rng(seed)

    def p(lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return dict(n=(p(-1, 1), p(-1, 1), p(-1, 1)),
                v=(p(-3, 3), p(-3, 3), p(-3, 3)),
                alb=(p(0.1, 1), p(0.1, 1), p(0.1, 1)), met=p(0, 1),
                rgh=p(0.05, 1), ao=p(0.2, 1))


def _ambient(fn, probe, s, conv, **kw):
    return fn(probe, tuple(map(conv, s["n"])), tuple(map(conv, s["v"])),
              tuple(map(conv, s["alb"])), conv(s["met"]), conv(s["rgh"]),
              conv(s["ao"]), **kw)


def _assert_ambient_close(got, want):
    """Few-ulp agreement: exp/exp2/atan2/acos of the two libraries differ
    in their last bits; tolerance relative to the ambient's peak."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 * scale)


def test_ambient_sh_matches_jax(probes):
    jsh, psh, _, _ = probes
    s = _shading(1)
    want = _ambient(jibl.ibl_ambient, jsh, s, jnp.asarray)
    got = _ambient(ibl.ibl_ambient, psh, s, cases.t)
    _assert_ambient_close(got, want)
    assert all(float(g.min()) >= 0.0 for g in got)


@pytest.mark.parametrize("kernels", [None, KERNELS, PLAIN],
                         ids=["xla", "kernels", "plain"])
def test_ambient_tables_match_jax(probes, kernels, monkeypatch):
    """The table path: with kernels its 16×32 / 32×64 tables sample
    through K7 (here its plain version), against the JAX package's
    small-table Pallas kernel in interpret mode; without, through the XLA
    sampler on both sides."""
    import bibim_tpu.ops.texture_quad as jtq

    _, _, jmaps, pmaps = probes
    s = _shading(2, (2, 1024))
    real = jtq.sample_table_small_pallas
    monkeypatch.setattr(jtq, "sample_table_small_pallas",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    want = _ambient(jibl.ibl_ambient, jmaps, s, jnp.asarray, tile_h=8,
                    tile_w=128, use_pallas=kernels is not None)
    got = _ambient(ibl.ibl_ambient, pmaps, s, cases.t, kernels=kernels)
    _assert_ambient_close(got, want)


def test_analytic_tracks_tables(probes):
    """The reference's own cross-check, on the port: the analytic fit and
    the u8 tables approximate the same convolved products."""
    _, psh, _, pmaps = probes
    s = _shading(3, (4, 128))
    s["ao"] = np.ones_like(s["ao"])
    a = _ambient(ibl.ibl_ambient, pmaps, s, cases.t)
    b = _ambient(ibl.ibl_ambient, psh, s, cases.t)
    scale = max(float(c.max()) for c in a)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) < 0.12 * scale


def test_ibl_frame_matches_jax(probes):
    """A deferred frame with table-path IBL (K6/K7 G-buffer sampling, the
    equirect tables through K7, K5) against the JAX package's
    render_frame."""
    _, _, jmaps, _ = probes
    cases.check_stretch_frame(cases.frame_inputs(), dict(enable_ibl=True),
                              jmaps)
