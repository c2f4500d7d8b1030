"""The TBN view and MeshScene in the port against the JAX package on the
CPU: the line parameters, ``rasterize_lines`` (three colours drawn in
order), ``corner_indices`` / ``interpolate``, ``_composite_tbn`` on the
test scene, the TBN frame on the (T, 3) geometry, ``MeshScene`` on an OBJ
written for the test, and the ``sphere_tbn_160x96`` /
``sphere_pbr_lights_gizmo_160x96`` goldens (the latter needs gizmo.obj)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu.ops import interpolate as jinterp
from bibim_tpu.ops.geometry import assemble_scene as j_assemble_scene
from bibim_tpu.ops.lines import rasterize_lines as j_rasterize_lines
from bibim_tpu.ops.raster import VisibilityBuffer as JVisibilityBuffer
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import interpolate
from bibim_tpu_torch.ops.geometry import assemble_scene
from bibim_tpu_torch.ops.lines import line_params, rasterize_lines
from bibim_tpu_torch.ops.raster import VisibilityBuffer
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.pipeline import framegraph as fg
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import assert_image_bound


def test_line_params_equal_jnp_linspace():
    """The 48 sample parameters bit for bit ``jnp.linspace(0, 1, 48)``."""
    for n in (2, 48, 100):
        np.testing.assert_array_equal(
            line_params(n, "cpu").numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def _segments(seed, n=300, h=40, w=64):
    rng = np.random.default_rng(seed)
    p0 = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                         rng.uniform(0.0, 1.0, (n, 1)),
                         rng.uniform(-0.2, 2.0, (n, 1))], 1)
    p1 = p0 + np.concatenate([rng.normal(0, 0.2, (n, 3)),
                              rng.normal(0, 0.05, (n, 1))], 1)
    depth = rng.uniform(0.0, 0.6, (h, w))
    image = rng.uniform(0.0, 1.0, (h, w, 3))
    return [a.astype(np.float32) for a in (p0, p1, depth, image)]


def test_rasterize_lines_matches_jax():
    """Three segment sets (red, green, blue) drawn in order over a seeded
    image and depth, as the TBN view draws them: bit for bit the JAX
    package's ``rasterize_lines`` (run op by op: both round each
    operation). Segments behind w = 0 or the scene depth draw nothing."""
    p0, p1, depth, image = _segments(0)
    want, got = jnp.asarray(image), torch.tensor(image)
    for k, color in enumerate(np.eye(3, dtype=np.float32)):
        sl = slice(100 * k, 100 * (k + 1))
        cols = np.broadcast_to(color, (100, 3))
        want = j_rasterize_lines(jnp.asarray(p0[sl]), jnp.asarray(p1[sl]),
                                 jnp.asarray(cols), jnp.asarray(depth), want)
        got = rasterize_lines(torch.tensor(p0[sl]), torch.tensor(p1[sl]),
                              torch.tensor(cols), torch.tensor(depth), got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = (got.numpy() != image).any(-1)
    assert 0.02 < drawn.mean() < 0.5


def test_interpolate_matches_jax():
    """``corner_indices`` and ``interpolate`` on a seeded visibility buffer
    (misses read triangle 0's corners)."""
    rng = np.random.default_rng(1)
    tris = rng.integers(0, 50, (20, 3)).astype(np.int32)
    tri_id = rng.integers(-1, 20, (6, 9)).astype(np.int32)
    bary = rng.uniform(0, 0.5, (6, 9, 2)).astype(np.float32)
    depth = rng.uniform(0, 1, (6, 9)).astype(np.float32)
    attr = rng.normal(0, 1, (50, 4)).astype(np.float32)
    jvis = JVisibilityBuffer(jnp.asarray(tri_id), jnp.asarray(bary),
                             jnp.asarray(depth))
    pvis = VisibilityBuffer(*(torch.tensor(a) for a in (tri_id, bary, depth)))
    jc = jinterp.corner_indices(jvis, jnp.asarray(tris))
    pc = interpolate.corner_indices(pvis, torch.tensor(tris))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    want = jinterp.interpolate(jvis, jc, jnp.asarray(attr))
    got = interpolate.interpolate(pvis, pc, torch.tensor(attr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-7,
                               atol=3e-7)


def test_composite_tbn_matches_jax():
    """``_composite_tbn`` on the test scene's (T, 3) soup over a seeded LDR
    image and the depth of a flat wall: the face centroids, averaged
    frames and endpoint projections go through 4-term products (XLA's
    dot on the other side), so a line sample may land one pixel over; at
    most 0.5 % of pixels differ. Every segment colour is drawn."""
    cases.cap_threads()
    scene, view, proj = cases.jax_scene()
    pin = cases.frame_inputs()[1]
    jsoup = j_assemble_scene(scene.batches, view, proj)
    psoup = assemble_scene(pin[0].batches, cases.t(view), cases.t(proj))
    rng = np.random.default_rng(2)
    ldr = [rng.uniform(0, 0.2, (cases.H, cases.W)).astype(np.float32)
           for _ in range(3)]
    depth = np.full((cases.H, cases.W), 0.002, np.float32)
    vp = np.asarray(jnp.matmul(proj, view,
                               precision=jax.lax.Precision.HIGHEST))
    s = jfg.RenderSettings(width=cases.W, height=cases.H)
    want = np.stack(jfg._composite_tbn(tuple(jnp.asarray(c) for c in ldr),
                                       jsoup, jnp.asarray(depth),
                                       jnp.asarray(vp), s), -1)
    got = torch.stack(fg._composite_tbn(
        tuple(cases.t(c) for c in ldr), psoup, cases.t(depth), cases.t(vp),
        RenderSettings(width=cases.W, height=cases.H)), -1).numpy()
    differ = (got != want).any(-1)
    assert differ.mean() <= 5e-3, differ.mean()
    for c in range(3):
        assert (got[..., c] == 1.0).sum() > 20


def test_tbn_legacy_frame_equals_planar():
    """The TBN frame on the (T, 3) main pass equals the planar frame's
    (which assembles the (T, 3) soup for the lines) bit for bit."""
    inputs = cases.frame_inputs()
    for kw in (dict(outputs="full"), dict(outputs="image", live_tile_cap=31)):
        a = cases.port_frame(inputs, show_tbn=True, **kw)["image"]
        b = cases.port_frame(inputs, show_tbn=True, geometry="legacy",
                             **kw)["image"]
        assert torch.equal(a, b)
        c = cases.port_frame(inputs, **kw)["image"]
        assert not torch.equal(a, c)


_OBJ = """# a tetrahedron with uvs and normals
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 0 1
vn 0 0 -1
vn 0 -1 0
vn -1 0 0
vn 0.577 0.577 0.577
f 1/1/1 3/3/1 2/2/1
f 1/1/2 2/2/2 4/3/2
f 1/1/3 4/3/3 3/2/3
f 2/1/4 3/2/4 4/3/4
"""


def test_mesh_scene_matches_jax(tmp_path):
    """MeshScene on an OBJ written here: the batch, model and lights equal
    the JAX package's MeshScene, a spun frame's model too, and the frame
    (plain chain and production) against the JAX package's render_frame
    at the golden bound. Other extensions raise."""
    from bibim_tpu.scene.meshscene import MeshScene as JMeshScene
    from bibim_tpu_torch.scene.meshscene import MeshScene, load_mesh_any

    cases.cap_threads()
    path = tmp_path / "tetra.obj"
    path.write_text(_OBJ)
    js = JMeshScene(path=str(path), scale=1.2)
    ps = MeshScene(path=str(path), scale=1.2, device="cpu")
    want_data = interop.scene_data(js.scene_data(), device="cpu")
    got_data = ps.scene_data()
    for f in ("positions", "uvs", "normals", "tangents", "colors",
              "indices", "model", "inv_model"):
        np.testing.assert_allclose(getattr(got_data.batches[0], f).numpy(),
                                   getattr(want_data.batches[0], f).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    for f in got_data.lights._fields:
        assert torch.equal(getattr(got_data.lights, f),
                           getattr(want_data.lights, f)), f
    js.spin = ps.spin = True
    js.update_scene(0.5)
    ps.update_scene(0.5)
    np.testing.assert_allclose(ps.scene_data().batches[0].model.numpy(),
                               np.asarray(js.scene_data().batches[0].model),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        load_mesh_any(tmp_path / "mesh.ply")

    jin, pin = cases.frame_inputs()
    want = np.asarray(jfg.render_frame(
        js.scene_data(), jin[1], jin[2], jin[3], jin[4],
        jfg.RenderSettings(outputs="image", **cases.FRAME_BASE))["image"])
    data = interop.scene_data(js.scene_data(), device="cpu")
    assert torch.equal(data.batches[0].model, ps.scene_data().batches[0].model)
    for kw in (dict(outputs="full"),
               dict(outputs="image+diag", live_tile_cap=31)):
        out = render_frame(ps.scene_data(), *pin[1:], RenderSettings(
            **{**cases.FRAME_BASE, **kw}))
        assert_image_bound(out["image"].numpy(), want)
        if "bin_diag" in out:
            check_bin_diag(out["bin_diag"])
    assert (want != 0).any(-1).mean() > 0.05


def _sphere_golden(name: str, overlay, frac_max=1e-3, **kw):
    out = render_frame(
        cases.golden_sphere_scene(), cases.golden_view(160, 96),
        cases.golden_params(), cases.checker_textures(), overlay,
        RenderSettings(width=160, height=96, outputs="image+diag", **kw))
    check_bin_diag(out["bin_diag"])
    assert_image_bound(out["image"].numpy(), cases.golden_png(name),
                       frac_max)


def test_sphere_tbn_golden_without_gizmo_mesh():
    """golden_configs' sphere_tbn_160x96 through the port. The frame draws
    neither the gizmo nor the light spheres, so the overlay resources need
    no gizmo.obj here."""
    from bibim_tpu_torch.pipeline import make_overlay_resources

    _sphere_golden("sphere_tbn_160x96",
                   make_overlay_resources(device="cpu", with_gizmo=False),
                   show_tbn=True, show_gizmo=False, show_lights=False)


@pytest.mark.parametrize("name,frac,kw", [
    # gizmo.obj is not in the repository, so this frame's fraction has not
    # been measured: it is held to the 0.25 % of the ShaderBall goldens,
    # whose gizmo is this one (the same camera rotation draws the same
    # 100² gizmo viewport). Without the gizmo the frame differs from the
    # JAX package's in 3 of its 15,360 pixels, by one LSB (measured).
    ("sphere_pbr_lights_gizmo_160x96", 2.5e-3, {}),
    ("sphere_tbn_160x96", 1e-3, dict(show_tbn=True, show_gizmo=False,
                                     show_lights=False)),
], ids=["sphere_pbr_lights_gizmo", "sphere_tbn"])
def test_sphere_goldens(name, frac, kw):
    """golden_configs' sphere frames through the port with the overlay
    resources of ``make_overlay_resources`` (gizmo.obj; skips without
    it)."""
    from bibim_tpu.utils.config import get_resource_root
    from bibim_tpu_torch.pipeline import make_overlay_resources

    root = get_resource_root()
    if not root.common("gizmo.obj").is_file():
        pytest.skip("gizmo.obj not found (resource root "
                    f"{root.common_root})")
    _sphere_golden(name, make_overlay_resources(device="cpu"), frac, **kw)
