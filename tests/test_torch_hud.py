"""The port's in-frame HUD (bibim_tpu_torch.host.hud and the frame's
``_composite_hud`` through the overlay composite K4) against the JAX
package: the cell geometry and text masks, the whole frame with
``show_hud=True`` (JAX's ``render_frame`` with XLA:CPU's FMA contraction
off, tests/torch_port_cases.py ``frames_without_fma``), the HUD-off frame
outside the text rows, and K4's plain version on the HUD's composite call
against the Pallas overlay kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.host import hud as jhud
from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops.raster import triangle_setup as j_setup
from bibim_tpu_torch.host import hud as phud
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops.raster import triangle_setup
from bibim_tpu_torch.pipeline import PLAIN, RenderSettings, render_frame
from bibim_tpu_torch.pipeline import framegraph as fg
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import FRAME_BASE as BASE

# The JAX package's HUD test (tests/test_pipeline.py TestHud).
SMALL_HUD = dict(max_chars=8, origin=(2, 2), scale=1)
SMALL_TEXT = "60.0FPS"
# The app's stats line (bibim_tpu/host/app.py hud_payload).
STATS = " 60.0 FPS  POS 0.0 1.0 3.0  YAW -90 PITCH 0"


@pytest.fixture(scope="module")
def inputs():
    return cases.frame_inputs()


@pytest.mark.parametrize("size", [
    dict(width=256, height=128, **SMALL_HUD),
    dict(width=1920, height=1080),
    dict(width=640, height=360, max_chars=12, origin=(0, 3), scale=3),
], ids=["small", "1080p_defaults", "scale3"])
def test_geometry_matches_jax(size):
    w, h = size.pop("width"), size.pop("height")
    got = phud.build_hud_geometry(w, h, **size)
    want = jhud.build_hud_geometry(w, h, **size)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("text", [
    SMALL_TEXT, STATS, "lower case, unknown ~glyphs & symbols: 50%",
    "X" * 60, "",
], ids=["small", "stats", "unknown_glyphs", "longer_than_max", "empty"])
def test_text_mask_matches_jax(text):
    for max_chars in (8, 48):
        got = phud.hud_text_mask(text, max_chars)
        want = jhud.hud_text_mask(text, max_chars)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert phud.FONT.keys() == jhud.FONT.keys()
    assert all(np.array_equal(phud.FONT[k], jhud.FONT[k]) for k in phud.FONT)


def _hud(text=SMALL_TEXT, **kw):
    geom = phud.build_hud_geometry(cases.W, cases.H, **{**SMALL_HUD, **kw})
    return geom, phud.hud_text_mask(text, geom.max_chars)


def test_hud_frame_matches_jax():
    """The port's HUD frame, full chain and production path, against the
    JAX package's render_frame with show_hud=True, both rounding every
    operation: within the golden bound, the float LDR planes held by
    assert_rounding_crossings, and the glyph pixels white."""
    ref, (full, prod) = cases.frames_without_fma(
        "frame", dict(show_hud=True),
        [dict(outputs="full", show_hud=True),
         dict(outputs="image", show_hud=True)],
        hud=dict(text=SMALL_TEXT, **SMALL_HUD))
    for port in (full, prod):
        cases.assert_image_bound(port["image"], ref["image"])
    cases.assert_rounding_crossings(full, ref)
    cases.assert_rounding_crossings(prod, ref, hdr_steps=4)
    lit = (ref["image"][:12, :60] == 255).all(axis=-1)
    assert lit.sum() > 50
    assert np.array_equal(lit, (full["image"][:12, :60] == 255).all(-1))


def test_hud_frame_outside_text_rows_is_hud_off_frame(inputs):
    """Below the text rows (2-8 at origin (2, 2), scale 1) the HUD frame is
    the HUD-off frame bit for bit; the HUD pass drops nothing."""
    kw = dict(outputs="image+diag", max_candidates=64, raster_passes=3,
              live_tile_cap=31, raster_tile_cap=32)
    off = cases.port_frame(inputs, **kw)
    _, pin = inputs
    on = render_frame(*pin, RenderSettings(**{**BASE, **kw,
                                              "show_hud": True}),
                      hud=_hud())
    check_bin_diag(on["bin_diag"])
    a, b = off["image"].numpy(), on["image"].numpy()
    np.testing.assert_array_equal(a[10:], b[10:])
    changed = (a != b).any(axis=-1)
    assert changed[2:9].any() and not changed[:2].any()
    assert (b[changed] == 255).all()


def test_show_hud_without_hud_is_hud_off_frame(inputs):
    base = cases.port_frame(inputs, outputs="image")
    _, pin = inputs
    out = render_frame(*pin, RenderSettings(**{**BASE, "outputs": "image",
                                               "show_hud": True}))
    assert torch.equal(out["image"], base["image"])
    off = render_frame(*pin, RenderSettings(**{**BASE, "outputs": "image"}),
                       hud=_hud())
    assert torch.equal(off["image"], base["image"])


def _jax_hud_records(geom, mask):
    """The JAX package's _composite_hud geometry, setup and records."""
    cx, cy = jnp.asarray(geom.cx), jnp.asarray(geom.cy)
    m = jnp.asarray(mask)
    n = cx.shape[0]
    offx = jnp.asarray([-1.0, 1.0, 1.0, -1.0], jnp.float32) * geom.dx
    offy = jnp.asarray([-1.0, -1.0, 1.0, 1.0], jnp.float32) * geom.dy
    x = (cx[:, None] + offx[None, :] * m[:, None]).reshape(-1)
    y = (cy[:, None] + offy[None, :] * m[:, None]).reshape(-1)
    ones = jnp.ones_like(x)
    clip = jnp.stack([x, y, ones, ones], axis=-1)
    base = (jnp.arange(n, dtype=jnp.int32) * 4)[:, None]
    tris = jnp.concatenate([base + jnp.asarray([[0, 1, 3]], jnp.int32),
                            base + jnp.asarray([[1, 2, 3]], jnp.int32)], 0)
    setup = j_setup(clip, tris, cases.W, cases.H)
    z2 = jnp.zeros((x.shape[0], 2), jnp.float32)
    z3 = jnp.zeros((x.shape[0], 3), jnp.float32)
    rec = jfused.build_record_table(setup, tris, z2, z3, z3, z3,
                                    jnp.ones_like(z3))
    return clip, tris, setup, rec


@pytest.mark.parametrize("scale", [1, 2])
def test_hud_overlay_plain_matches_pallas_interpret(scale):
    """K4's plain version on the HUD's composite call (the frame's
    capacities; a line that fills the frame's width) against
    composite_overlay_pallas in interpret mode: the same composited
    pixels, colours within the overlay test's bound, the same BinDiag;
    the port's cell geometry equal to the JAX package's, its setup's
    bounding boxes too, its records within a few ulps (XLA:CPU's FMAs).
    Both composites scan the JAX package's records."""
    cases.cap_threads()
    geom = phud.build_hud_geometry(cases.W, cases.H, max_chars=40 // scale,
                                   origin=(1, 1), scale=scale)
    mask = phud.hud_text_mask(STATS, geom.max_chars)
    jclip, jtris, jsetup, jrec = _jax_hud_records(geom, mask)
    clip, tris = fg._hud_geometry((geom, mask), torch.device("cpu"))
    assert torch.equal(clip, cases.t(jclip))
    assert torch.equal(tris, cases.t(jtris))
    setup = triangle_setup(clip, tris, cases.W, cases.H)
    for a, b in zip(setup.bbox, np.asarray(jsetup.bbox).T):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(setup.valid.numpy(), np.asarray(jsetup.valid))
    rec = fused.build_record_table(setup, tris, *(torch.zeros(
        (clip.shape[0], k)) for k in (2, 3, 3, 3)), torch.ones(
        (clip.shape[0], 3)))
    np.testing.assert_allclose(rec.numpy(), cases.record_table(jrec).numpy(),
                               rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(5)
    npx = cases.TILE_H * cases.TILE_W
    ldr3 = tuple(rng.uniform(0, 1, (cases.NT, npx)).astype(np.float32)
                 for _ in range(3))
    caps = dict(max_candidates=512, overflow_cap=64, span_cap=4,
                max_tiles=min(64, cases.NT))
    want, wdiag = jfused.composite_overlay_pallas(
        jrec, jsetup, tuple(map(jnp.asarray, ldr3)),
        jnp.zeros((cases.NT, npx), jnp.int32), cases.W, cases.H,
        interpret=True, **caps)
    got, diag = fused.composite_overlay(
        cases.record_table(jrec), setup,
        torch.stack([cases.t(c) for c in ldr3]), None,
        cases.W, cases.H, overlay=PLAIN.overlay, **caps)
    for a, b in zip(diag, wdiag):
        assert int(a) == int(b) == 0
    n_changed = 0
    for c in range(3):
        g, w = got[c].numpy(), np.asarray(want[c])
        np.testing.assert_array_equal(g == ldr3[c], w == ldr3[c])
        np.testing.assert_allclose(g, w, atol=1e-5)
        n_changed += int((g != ldr3[c]).sum())
    assert n_changed > 100 * scale * scale

