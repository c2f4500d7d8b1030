"""The instanced ShaderBall path of the port (BASELINE config 4) against the
JAX package on the CPU: host frustum culling, the capacity probe and its
derivation, and a small config-4-like frame rendered with the default,
early-z and fine-bin rasters. Also: the port names no module of the JAX
package, and its own copies of the asset loaders give the JAX package's
arrays."""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from bibim_tpu import math3d as jm3
from bibim_tpu.pipeline import autotune as jat
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu.scene import culling as jcull
from bibim_tpu_torch import interop
from bibim_tpu_torch.pipeline import autotune as pat
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.scene import culling as pcull
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------

def _port_sources():
    files = sorted((REPO / "bibim_tpu_torch").rglob("*.py"))
    tools = [REPO / "tools" / f for f in ("torch_profile.py",
                                          "sass_counts.py",
                                          "shade_variants.py")]
    return files + [REPO / "chip_smoke.py"] + tools


def test_port_imports_no_jax_package():
    """No import in the port, chip_smoke.py or its GPU tools
    (tools/torch_profile.py, sass_counts.py, shade_variants.py) names
    bibim_tpu (or jax); the package imports without either."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("bibim_tpu", "jax", "jaxlib"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad, bad
    assert len(_port_sources()) > 30


# ---------------------------------------------------------------------------
# The copied loaders
# ---------------------------------------------------------------------------

_OBJ = """# two quads, two materials
mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 1 0
usemtl red
f 1/1/1 2/2/1 3/3/1 4/1/1
usemtl green
f -1//2 -2//2 -4//2
"""
_MTL = """newmtl red
Kd 1 0 0
newmtl green
Kd 0 1 0.5
"""


def _same_mesh(got, want):
    for f in ("positions", "uvs", "normals", "tangents", "indices"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))
    if want.colors is None:
        assert got.colors is None
    else:
        np.testing.assert_array_equal(got.colors, want.colors)


def test_obj_loader_matches_jax(tmp_path):
    from bibim_tpu.assets.obj import load_obj as jload
    from bibim_tpu_torch.assets.obj import load_obj

    (tmp_path / "g.obj").write_text(_OBJ)
    (tmp_path / "m.mtl").write_text(_MTL)
    for bake in (True, False):
        got = load_obj(tmp_path / "g.obj", bake_diffuse_colors=bake)
        _same_mesh(got, jload(tmp_path / "g.obj", bake_diffuse_colors=bake))
    assert got.name == "g"


def test_image_loader_matches_jax(tmp_path):
    """RGB, RGBA, 8-bit and 16-bit grey PNGs and a JPEG decode to the JAX
    package's bytes."""
    from PIL import Image

    from bibim_tpu.assets.image import load_image_rgba8 as jload
    from bibim_tpu_torch.assets.image import load_image_rgba8

    rng = np.random.default_rng(5)
    imgs = {
        "rgb.png": Image.fromarray(rng.integers(0, 256, (9, 7, 3), np.uint8)),
        "rgba.png": Image.fromarray(rng.integers(0, 256, (5, 6, 4),
                                                 np.uint8)),
        "grey.png": Image.fromarray(rng.integers(0, 256, (4, 4), np.uint8)),
        "grey16.png": Image.fromarray(
            rng.integers(0, 65536, (6, 5)).astype(np.uint16)),
        "photo.jpg": Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                                  np.uint8)),
    }
    for name, im in imgs.items():
        im.save(tmp_path / name)
        got = load_image_rgba8(tmp_path / name)
        want = jload(tmp_path / name)
        assert got.dtype == np.uint8 and got.shape[2] == 4, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_material_set_matches_jax(tmp_path):
    """A pbr/ tree with a default material and a partial one: every map
    (with its per-map fallback) equals the JAX package's."""
    from PIL import Image

    from bibim_tpu.assets.materials import PBRMapType as JMap
    from bibim_tpu.assets.materials import (
        _create_pbr_material_set_uncached as jcreate,
    )
    from bibim_tpu_torch.assets.materials import (
        PBRMapType,
        create_pbr_material_set,
    )

    rng = np.random.default_rng(2)
    for mat, maps in (("default", ("albedo", "normal", "roughness")),
                      ("brick", ("albedo", "metallic")), ("empty", ())):
        d = tmp_path / mat
        d.mkdir()
        for m in maps:
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(
                d / f"{m}.png")
    got = create_pbr_material_set(tmp_path)
    want = jcreate(tmp_path)
    assert got.names == want.names == ["brick", "empty"]
    for i in range(2):
        for t in PBRMapType:
            g = got.get_pbr_map_or_default(i, t)
            w = want.get_pbr_map_or_default(i, JMap(int(t)))
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_resource_root_matches_jax():
    from bibim_tpu.utils.config import get_resource_root as jroot
    from bibim_tpu_torch.utils.config import get_resource_root

    assert get_resource_root().common("x") == jroot().common("x")
    assert get_resource_root().shader("y") == jroot().shader("y")


def test_real_assets_match_jax():
    """ShaderBall.fbx and the cube images, where the assets exist."""
    from bibim_tpu.utils.config import get_resource_root

    root = get_resource_root()
    fbx = root.common("ShaderBall.fbx")
    images = [root.common(n) for n in ("uv_debug.png", "texture.jpg")]
    if not fbx.is_file() and not any(p.is_file() for p in images):
        pytest.skip(f"assets not present under {root.common_root}")
    if fbx.is_file():
        from bibim_tpu.assets.fbx import _load_fbx_mesh_uncached as jload
        from bibim_tpu_torch.assets.fbx import load_fbx_mesh

        mesh = load_fbx_mesh(fbx)
        _same_mesh(mesh, jload(fbx))
        assert mesh.indices.shape[0] > 9000
    for p in images:
        if p.is_file():
            from bibim_tpu.assets.image import load_image_rgba8 as jimg
            from bibim_tpu_torch.assets.image import load_image_rgba8

            np.testing.assert_array_equal(load_image_rgba8(p), jimg(p))


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------

def _jax_ball_batch(n=64):
    from bibim_tpu.assets.meshgen import generate_uv_sphere_mesh
    from bibim_tpu.scene.scene import batch_from_mesh
    from bibim_tpu.scene.shaderball import shaderball_instance_matrices

    model, _ = shaderball_instance_matrices(n, -90.0)
    return batch_from_mesh(generate_uv_sphere_mesh(100.0, 20, 11),
                           np.asarray(model))


def _bench_views():
    """The bench camera, an orbit to yaw -25, one 20 units along x, and one
    looking away (everything culled)."""
    from bibim_tpu.scene.camera import FreeLookCamera

    pos = np.array([8.0, 6.0, -14.0], np.float32)
    return [FreeLookCamera(pos=pos), FreeLookCamera(pos=pos, yaw=-25.0),
            FreeLookCamera(pos=pos + np.float32([20, 0, 0])),
            FreeLookCamera(pos=pos, yaw=180.0)]


def test_culling_matches_jax():
    """visible_instances and the bucket-padded matrices are bit-equal to
    the JAX package's on the same host matrices."""
    jb = _jax_ball_batch()
    host = interop.batch_host_instances(jb)
    pbatch = interop.draw_batch(jb, device="cpu")
    proj = np.asarray(jm3.perspective(60.0, 16 / 9, 0.1, 1000.0))
    buckets = []
    for cam in _bench_views():
        vp = proj @ cam.get_view_matrix()
        np.testing.assert_array_equal(pcull.visible_instances(host, vp),
                                      jcull.visible_instances(jb, vp))
        got = pcull.cull_batch(pbatch, host, vp)
        want = jcull.cull_batch(jb, vp)
        np.testing.assert_array_equal(got.model.numpy(),
                                      np.asarray(want.model))
        np.testing.assert_array_equal(got.inv_model.numpy(),
                                      np.asarray(want.inv_model))
        buckets.append(got.model.shape[0])
    assert buckets[0] < 64 and len(set(buckets)) > 1 and buckets[-1] == 1


def test_shaderball_scene_culls_like_jax():
    """The port's ShaderBallScene (stand-in mesh) culled on the host for
    the bench camera: the JAX package's culled scene, carried across."""
    from bibim_tpu.assets.meshgen import generate_uv_sphere_mesh as jsphere
    from bibim_tpu.scene.scene import SceneData, batch_from_mesh
    from bibim_tpu.scene.shaderball import (
        shaderball_instance_matrices,
        shaderball_lights,
    )
    from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
    from bibim_tpu_torch.scene.shaderball import (
        ShaderBallScene,
        instanced_camera,
    )

    scene = ShaderBallScene(num_instances=64, device="cpu",
                            ball_mesh=generate_uv_sphere_mesh(100.0, 20, 11))
    cam = instanced_camera()
    proj = np.asarray(jm3.perspective(60.0, 16 / 9, 0.1, 1000.0))
    got = scene.culled_scene_data(cam.get_view_matrix(), proj)

    model, _ = shaderball_instance_matrices(64, -90.0)
    plane = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane[1, 3] = -10.0
    from bibim_tpu.assets.meshgen import generate_plane_mesh

    jscene = SceneData(
        batches=(batch_from_mesh(jsphere(100.0, 20, 11), np.asarray(model)),
                 batch_from_mesh(generate_plane_mesh(), plane)),
        lights=shaderball_lights())
    want = interop.scene_data(jcull.cull_scene_instances(
        jscene, cam.get_view_matrix(), proj), device="cpu")
    for g, w in zip(got.batches, want.batches):
        np.testing.assert_array_equal(g.model.numpy(), w.model.numpy())
        np.testing.assert_array_equal(g.positions.numpy(),
                                      w.positions.numpy())
    assert got.batches[0].model.shape[0] == 16
    assert scene.scene_data().batches[0].model.shape[0] == 64


# ---------------------------------------------------------------------------
# Probe and derivation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inst():
    cases.cap_threads()
    scene, view, proj = cases.instanced_scene()
    vb = jfg.ViewBlock(view=view, proj=proj, view_pos=jnp.zeros(3),
                       enable_normal_map=jnp.int32(0))
    return (scene, vb, interop.scene_data(scene, device="cpu"),
            interop.view_block(vb, device="cpu"))


_BASE = dict(width=cases.W, height=cases.H, show_lights=False,
             show_gizmo=False, outputs="image", span_cap=16)


@pytest.mark.parametrize("extra", [dict(), dict(fine_bins=True)],
                         ids=["coarse", "fine_bins"])
def test_bin_stats_match_jax(inst, extra):
    """The probe's binning statistics from one setup carried across: every
    integer equals the JAX package's."""
    from bibim_tpu.ops.geometry import assemble_scene_planar
    from bibim_tpu.ops.raster import triangle_setup_planar
    from bibim_tpu_torch.ops.sort import sort_keys

    jscene, jvb, _, _ = inst
    soup = assemble_scene_planar(jscene.batches, jvb.view, jvb.proj)
    setup = triangle_setup_planar(soup.clip, cases.W, cases.H)
    want = jat._bin_stats(setup, jfg.RenderSettings(**_BASE, **extra),
                          cases.W, cases.H)
    got = pat._bin_stats(cases.planar_setup(setup),
                         RenderSettings(**_BASE, **extra), cases.W, cases.H,
                         sort_keys)
    assert set(got) == set(want)
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}


@pytest.mark.parametrize("extra", [dict(), dict(fine_bins=True)],
                         ids=["coarse", "fine_bins"])
def test_probe_matches_jax(inst, extra):
    """probe_frame_caps end to end, each package from its own vertex stage:
    tile counts, the worst tile, the overflow list and the covered tiles of
    the open-capacity raster equal; pair sums within 0.5 % (XLA:CPU's FMA
    contraction moves a triangle's bbox by a pixel here and there)."""
    jscene, jvb, pscene, pvb = inst
    got = pat.probe_frame_caps(pscene, pvb, RenderSettings(**_BASE, **extra))
    want = interop.cap_probe(jat.probe_frame_caps(
        jscene, jvb, jfg.RenderSettings(**_BASE, **extra)))
    for f in ("n_tiles", "bin_tiles", "covered_tiles", "max_candidates",
              "n_big", "n_tris", "dense_tiles", "escape_tiles"):
        assert getattr(got, f) == getattr(want, f), f
    assert abs(got.total_pairs - want.total_pairs) <= 0.005 * want.total_pairs
    assert abs(got.group_win - want.group_win) <= 0.005 * want.group_win
    for g, w in zip(got.span_big, want.span_big):
        assert g[:2] == w[:2] and abs(g[2] - w[2]) <= 0.005 * w[2]
    assert got.max_candidates > 256 and got.covered_tiles > 0


def _settings_dict(s):
    return {f.name: (int(v) if f.name == "gbuffer_viz" else v)
            for f in dataclasses.fields(s)
            for v in (getattr(s, f.name),)}


_PROBES = [
    # Config 4's shape: a dense worst tile → 5 passes of 512, merged.
    jat.CapProbe(n_tiles=4080, bin_tiles=1400, covered_tiles=1300,
                 max_candidates=2150, total_pairs=310_000, n_big=2,
                 span_big=((2, 9000, 300_000), (4, 700, 305_000),
                           (8, 40, 309_000), (16, 2, 310_000)),
                 n_tris=160_002, dense_tiles=95, group_win=9000,
                 small_pair_frac=0.9),
    # Config 3's shape: one pass, group window from group_win.
    jat.CapProbe(n_tiles=4080, bin_tiles=1200, covered_tiles=1100,
                 max_candidates=380, total_pairs=20_000, n_big=2,
                 span_big=((2, 600, 17_000), (4, 80, 19_000),
                           (8, 5, 19_800), (16, 2, 20_000)),
                 n_tris=10_002, dense_tiles=0, group_win=1500,
                 small_pair_frac=0.4),
]


@pytest.mark.parametrize("probe_i", [0, 1], ids=["x64", "headline"])
@pytest.mark.parametrize("extra", [
    dict(), dict(early_z=True), dict(fine_bins=True),
    dict(group_pair_cap=512), dict(show_lights=True)],
    ids=["default", "early_z", "fine_bins", "group_pair_cap", "lights"])
def test_derive_matches_jax(probe_i, extra):
    """derive_settings and dense_cap_candidates: the JAX package's settings
    from one probe, at the bench's margin and the default one."""
    jprobe = _PROBES[probe_i]
    pprobe = interop.cap_probe(jprobe)
    for margin in (1.05, 1.25):
        kw = dict(width=1920, height=1080, **extra)
        got = pat.derive_settings(RenderSettings(**kw), pprobe, margin)
        want = jat.derive_settings(jfg.RenderSettings(**kw), jprobe, margin)
        assert _settings_dict(got) == _settings_dict(want)
        gc = pat.dense_cap_candidates(got, pprobe, margin)
        wc = jat.dense_cap_candidates(want, jprobe, margin)
        assert [_settings_dict(s) for s in gc] == [_settings_dict(s)
                                                   for s in wc]
    if probe_i == 0 and not extra:
        assert got.raster_passes == 6 and got.merged_coverage
        assert len(gc) == 2


def test_autotune_matches_jax(inst):
    """autotune_settings end to end (probe, derivation, span re-probe) on
    the instanced test frame; pick_measured picks the fastest."""
    jscene, jvb, pscene, pvb = inst
    kw = dict(_BASE, span_cap=64)
    got, gp = pat.autotune_settings(pscene, pvb, RenderSettings(**kw),
                                    margin=1.05)
    want, wp = jat.autotune_settings(jscene, jvb, jfg.RenderSettings(**kw),
                                     margin=1.05)
    assert gp.max_candidates == wp.max_candidates
    assert _settings_dict(got) == _settings_dict(want)
    assert got.span_cap < 64
    cands = (got, dataclasses.replace(got, dense_tile_cap=128))
    best, res = pat.pick_measured(cands, lambda s: s.dense_tile_cap or 0)
    assert best is min(cands, key=lambda s: s.dense_tile_cap or 0)
    assert [r[1] for r in res] == list(cands)


@pytest.mark.parametrize("extra", [
    dict(pair_sampling=2), dict(enable_shadows=True),
    dict(show_lights=True)],
    ids=["pair_sampling", "shadows", "light_spheres"])
def test_autotune_unported_parts_raise(inst, extra):
    _, _, pscene, pvb = inst
    assert pscene.lights.num_lights > 0
    with pytest.raises(NotImplementedError):
        pat.autotune_settings(pscene, pvb,
                              RenderSettings(**dict(_BASE, **extra)))


# ---------------------------------------------------------------------------
# The config-4-like frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_in(inst):
    from bibim_tpu.ops import texture_quad as jtq

    jscene, jvb, pscene, pvb = inst
    jvb = jvb._replace(enable_normal_map=jnp.int32(1))
    mats = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    fp = jfg.FrameParams(enable_tone_mapping=jnp.int32(1),
                         exposure=jnp.float32(1.0))
    want = np.asarray(jfg.render_frame(
        jscene, jvb, fp, mats, None,
        jfg.RenderSettings(**dict(_BASE, max_candidates=512,
                                  xla_cap=2048)))["image"])
    return ((pscene, interop.view_block(jvb, device="cpu"),
             interop.frame_params(fp, device="cpu"),
             interop.material_tables(mats, device="cpu")), want)


# Caps that force 3 depth-chained passes on compacted grids.
_MULTI = dict(_BASE, outputs="image+diag", max_candidates=128,
              raster_passes=3, raster_tile_cap=32, dense_tile_cap=16,
              live_tile_cap=31, span_mid_cap=512)


def test_instanced_frame_variants_match_jax(frame_in):
    """Default, early-z, fine-bin and merged-coverage renders of the
    instanced frame: zero drops, identical to each other, within the
    golden bound of the JAX package's render_frame."""
    (pscene, pvb, pfp, pmats), want = frame_in
    images = []
    for extra in (dict(), dict(early_z=True), dict(fine_bins=True),
                  dict(merged_coverage=True)):
        out = render_frame(pscene, pvb, pfp, pmats, None,
                           RenderSettings(**_MULTI, **extra))
        check_bin_diag(out["bin_diag"])
        images.append(out["image"].numpy())
    for img in images[1:]:
        np.testing.assert_array_equal(img, images[0])
    # 0.2380 % of pixels differ, by up to 2 LSB (measured): XLA:CPU's FMA
    # differences carried across RGBA16F rounding boundaries and through
    # the u8 taps of the 2-4 px triangles (tests/torch_port_cases.py
    # NO_FMA_XLA_FLAGS); held against the JAX frame without FMAs.
    cases.assert_image_bound(images[0], want, 2.97e-3)
    assert (images[0] != 0).any(axis=-1).mean() > 0.3
    ref, (port,) = cases.frames_without_fma(
        "instanced", dict(max_candidates=512, xla_cap=2048), [_MULTI])
    cases.assert_rounding_crossings(port, ref, hdr_steps=4)
