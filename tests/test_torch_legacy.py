"""The legacy material bindings and the shared-vertex (T, 3) geometry in
the port against the JAX package on the CPU: the image-space samplers
(``ops.texture``: ``sample_nearest``, ``sample_bilinear``, ``quad_uv_lod``,
``sample_trilinear``), ``assemble_scene`` and the (T, 3) setup and record
table, the binding converters, and frames: hand-built shared-vertex
batches (``sequential_tris=False``) with shadows, a single MipQuadTable
binding, the cube scene on a per-material tuple of MaterialTextures and
MaterialMips, and the ``triangle_pbr_128x64`` golden."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu import math3d as jm3
from bibim_tpu.assets.image import build_mip_pyramid as j_mip_pyramid
from bibim_tpu.assets.meshgen import (
    generate_plane_mesh,
    generate_uv_sphere_mesh,
)
from bibim_tpu.ops import fused as jfused
from bibim_tpu.ops import texture as jtx
from bibim_tpu.ops import texture_quad as jtq
from bibim_tpu.ops.geometry import assemble_scene as j_assemble_scene
from bibim_tpu.ops.raster import triangle_setup as j_triangle_setup
from bibim_tpu.pipeline import framegraph as jfg
from bibim_tpu.scene.scene import DrawBatch as JDrawBatch
from bibim_tpu.scene.scene import SceneData as JSceneData
from bibim_tpu.scene.shaderball import shaderball_lights
from bibim_tpu_torch import interop
from bibim_tpu_torch.ops import fused
from bibim_tpu_torch.ops import texture as tx
from bibim_tpu_torch.ops.geometry import assemble_scene
from bibim_tpu_torch.ops.raster import triangle_setup
from bibim_tpu_torch.pipeline import (
    KERNELS,
    Kernels,
    MaterialMips,
    MaterialTextures,
    RenderSettings,
    render_frame,
)
from bibim_tpu_torch.pipeline import framegraph as fg
from bibim_tpu_torch.scene import TriangleScene
from bibim_tpu_torch.scene.cube import cube_material_tables
from bibim_tpu_torch.utils.validation import check_bin_diag
from tests import torch_port_cases as cases
from tests.torch_port_cases import assert_image_bound


def _img(seed, h, w, c=4, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return rng.uniform(0, 1, (h, w, c)).astype(np.float32)


def _uv_image(seed, h=13, w=22):
    """An (H, W, 2) uv image with odd sides: an affine ramp (a footprint
    per pixel quad) plus noise, wrapping past [0, 1)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    u = -0.3 + 0.071 * x + 0.013 * y + rng.normal(0, 0.01, (h, w))
    v = 1.2 - 0.009 * x + 0.043 * y + rng.normal(0, 0.01, (h, w))
    return np.stack([u, v], -1).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_sample_nearest_bilinear_match_jax(dtype):
    """Nearest and bilinear samples with REPEAT wrap on u8 and float
    textures, against the JAX package's (op by op) within 3e-7."""
    tex = _img(1, 9, 14, dtype=dtype)
    uv = _uv_image(2)
    for jfn, pfn in ((jtx.sample_nearest, tx.sample_nearest),
                     (jtx.sample_bilinear, tx.sample_bilinear)):
        want = np.asarray(jfn(jnp.asarray(tex), jnp.asarray(uv)))
        got = pfn(cases.t(tex), cases.t(uv)).numpy()
        assert got.shape == want.shape == (13, 22, 4)
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=3e-7)


def test_quad_lod_and_trilinear_match_jax():
    """``quad_uv_lod`` (odd sides padded with the edge LOD) and
    ``sample_trilinear`` over a ``build_mip_atlas`` pyramid: the LOD
    within 1e-6 relative (the two packages' log2 round differently), the
    trilinear sample at the
    JAX package's LOD within 3e-7."""
    tex = _img(3, 32, 16)
    mips = j_mip_pyramid(tex)
    ja = jtx.build_mip_atlas(mips)
    pa = tx.build_mip_atlas(mips, device="cpu")
    conv = interop.mip_atlas(ja, device="cpu")
    for f in ("texels", "offsets", "heights", "widths"):
        assert torch.equal(getattr(pa, f), getattr(conv, f)), f
    assert pa.num_levels == conv.num_levels == len(mips)
    uv = _uv_image(4)
    want_lod = np.asarray(jtx.quad_uv_lod(jnp.asarray(uv), ja.heights[0],
                                          ja.widths[0]))
    got_lod = tx.quad_uv_lod(cases.t(uv), pa.heights[0], pa.widths[0])
    np.testing.assert_allclose(got_lod.numpy(), want_lod, rtol=1e-6,
                               atol=1e-7)
    assert 0.5 < float(want_lod.max()) and float(want_lod.min()) == 0.0
    want = np.asarray(jtx.sample_trilinear(ja, jnp.asarray(uv),
                                           jnp.asarray(want_lod)))
    got = tx.sample_trilinear(pa, cases.t(uv), cases.t(want_lod)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=3e-7)


def _shared_vertex_scenes():
    """(JAX SceneData, port SceneData): a shared-vertex UV sphere drawn as
    two instances and the 100× ground plane, hand-built (indexed vertices,
    no corner planes), with the ShaderBall lights."""
    sphere = generate_uv_sphere_mesh(0.6, 20, 12)
    plane = generate_plane_mesh()
    models = np.stack([np.asarray(jm3.translate([-0.7, -0.4, 3.0])),
                       np.asarray(jm3.translate([0.8, -0.2, 3.6]))])
    plane_model = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane_model[1, 3] = -1.5

    def batch(mesh, model):
        model = np.asarray(model, np.float32).reshape(-1, 4, 4)
        inv = np.linalg.inv(model.astype(np.float64)).astype(np.float32)
        colors = (mesh.colors if mesh.colors is not None
                  else np.ones_like(mesh.positions))
        return JDrawBatch(
            positions=jnp.asarray(mesh.positions), uvs=jnp.asarray(mesh.uvs),
            normals=jnp.asarray(mesh.normals),
            tangents=jnp.asarray(mesh.tangents), colors=jnp.asarray(colors),
            indices=jnp.asarray(mesh.indices, jnp.int32),
            model=jnp.asarray(model), inv_model=jnp.asarray(inv))

    scene = JSceneData(batches=(batch(sphere, models),
                                batch(plane, plane_model)),
                       lights=shaderball_lights())
    return scene, interop.scene_data(scene, device="cpu")


def test_assemble_scene_and_records_match_jax():
    """``assemble_scene`` over instanced shared-vertex batches: corner ids
    and material ids equal, vertex arrays within 4 ulps (the four-term
    products in order, XLA's dot on the other side); the (T, 3) setup and
    record table against the JAX package's on the same clip coordinates;
    the ``sequential`` fast path on a de-indexed mesh equal to the
    gather."""
    cases.cap_threads()
    jscene, pscene = _shared_vertex_scenes()
    # interop.draw_batch carries a batch without corner planes as one.
    assert all(b.corner_planes is None for b in pscene.batches)
    _, view, proj = cases.jax_scene()
    ids = (1, 0)
    want = j_assemble_scene(jscene.batches, view, proj, ids)
    got = assemble_scene(pscene.batches, cases.t(view), cases.t(proj), ids)
    np.testing.assert_array_equal(got.tris.numpy(), np.asarray(want.tris))
    np.testing.assert_array_equal(got.mat_id.numpy(),
                                  np.asarray(want.mat_id))
    for f in ("clip", "world", "normal", "tangent", "uv", "color"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_allclose(g, w, rtol=4 * 2.0 ** -23, atol=1e-6,
                                   err_msg=f)
    clip = np.asarray(want.clip)
    tris = np.asarray(want.tris)
    js = j_triangle_setup(jnp.asarray(clip), jnp.asarray(tris), cases.W,
                          cases.H)
    ps = triangle_setup(cases.t(clip), cases.t(tris), cases.W, cases.H)
    np.testing.assert_array_equal(ps.valid.numpy(), np.asarray(js.valid))
    for k, name in enumerate(("bx0", "by0", "bx1", "by1")):
        np.testing.assert_array_equal(ps.bbox[k].numpy(),
                                      np.asarray(js.bbox[:, k]), name)
    jrec = jfused.build_record_table(
        js, jnp.asarray(tris), want.uv, want.normal, want.tangent,
        want.world, want.color, want.mat_id)
    prec = fused.build_record_table(
        ps, cases.t(tris), *(cases.t(np.asarray(getattr(want, f)))
                             for f in ("uv", "normal", "tangent", "world",
                                       "color", "mat_id")))
    np.testing.assert_allclose(prec.numpy(), cases.record_table(jrec).numpy(),
                               rtol=4 * 2.0 ** -23, atol=1e-6)
    # De-indexed: the reshape path equals the gather.
    seq = assemble_scene(cases.frame_inputs()[1][0].batches, cases.t(view),
                         cases.t(proj))
    a = triangle_setup(seq.clip, seq.tris, cases.W, cases.H, sequential=True)
    b = triangle_setup(seq.clip, seq.tris, cases.W, cases.H)
    attrs = (seq.uv, seq.normal, seq.tangent, seq.world, seq.color,
             seq.mat_id)
    assert torch.equal(
        fused.build_record_table(a, seq.tris, *attrs, sequential=True),
        fused.build_record_table(b, seq.tris, *attrs))


def _mip_maps(seed):
    maps = cases.material_maps(seed)
    return {k: j_mip_pyramid(m) for k, m in maps.items()}


def _spy(calls: dict) -> Kernels:
    def wrap(name, fn):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return run

    return Kernels(*(wrap(n, f) for n, f in zip(Kernels._fields, KERNELS)))


def test_shared_vertex_shadow_frame_matches_jax():
    """Hand-built shared-vertex batches (``sequential_tris=False``: the
    (T, 3) vertex stage, setup and records on K1, and the (T, 3) shadow
    pass fit to the spheres' vertex rows) against the JAX package's frame:
    triangle ids equal, the plain chain and the compacted production frame
    at the golden bound, zero drops; and bit for bit the port's planar
    frame of the same meshes de-indexed (``batch_from_mesh``)."""
    from bibim_tpu_torch.scene.scene import SceneData, batch_from_mesh

    cases.cap_threads()
    jscene, pscene = _shared_vertex_scenes()
    jin, (_, vb, fp, pmats, overlay) = cases.frame_inputs()
    kw = dict(cases.FRAME_BASE, sequential_tris=False, **cases.SHADOWS)
    want = jax.tree_util.tree_map(np.asarray, jfg.render_frame(
        jscene, jin[1], jin[2], jin[3], jin[4],
        jfg.RenderSettings(outputs="full", **kw)))
    prod_kw = dict(outputs="image+diag", max_candidates=64,
                   raster_passes=3, live_tile_cap=31, raster_tile_cap=32,
                   shadow_tile_cap=64, shadow_query_tile_cap=24)
    full = render_frame(pscene, vb, fp, pmats, overlay,
                        RenderSettings(outputs="full", **kw))
    np.testing.assert_array_equal(full["tri_id"].numpy(), want["tri_id"])
    assert 0.3 < (want["tri_id"] >= 0).mean()
    # 0.1007 % of pixels differ by one LSB (measured) on either render:
    # the FMA crossings of the planar shadow frame (test_torch_shadow.py,
    # held there against the JAX frame without FMAs); this frame is the
    # port's planar frame of the same meshes bit for bit (below).
    assert_image_bound(full["image"].numpy(), want["image"], 1.1e-3)
    calls = {}
    prod = render_frame(pscene, vb, fp, pmats, overlay,
                        RenderSettings(**{**kw, **prod_kw}),
                        kernels=_spy(calls))
    check_bin_diag(prod["bin_diag"])
    assert_image_bound(prod["image"].numpy(), want["image"], 1.1e-3)
    assert calls["shade"] == 1 and calls["raster"] >= 2
    unlit = render_frame(pscene, vb, fp, pmats, overlay, RenderSettings(
        outputs="image", **dict(kw, enable_shadows=False)))
    assert not np.array_equal(unlit["image"].numpy(), prod["image"].numpy())
    deindexed = SceneData(
        batches=tuple(batch_from_mesh(_mesh_of(b), b.model.numpy(),
                                      device="cpu")
                      for b in pscene.batches), lights=pscene.lights)
    for out, okw in ((full, dict(outputs="full")), (prod, prod_kw)):
        planar = render_frame(deindexed, vb, fp, pmats, overlay,
                              RenderSettings(**{**kw, **okw,
                                                "sequential_tris": True}))
        assert torch.equal(out["image"], planar["image"])


def _mesh_of(b):
    from bibim_tpu_torch.scene.meshgen import Mesh

    return Mesh(positions=b.positions.numpy(), uvs=b.uvs.numpy(),
                normals=b.normals.numpy(), tangents=b.tangents.numpy(),
                indices=b.indices.numpy(), colors=b.colors.numpy())


def test_mip_quad_binding_frame_matches_jax():
    """A single material bound as MipQuadTables (trilinear through the quad
    oracle — K7 would take single-level small groups — then K5) with
    shadows, against the JAX package's frame: the plain chain and the
    compacted production frame at the golden bound."""
    cases.cap_threads()
    inputs = cases.frame_inputs()
    jin, pin = inputs
    jmats = jtq.build_mip_quad_tables(_mip_maps(6))
    assert {type(t).__name__ for t in jmats} == {"MipQuadTable"}
    pmats = interop.materials(jmats, device="cpu")
    want = np.asarray(jfg.render_frame(
        *jin[:3], jmats, jin[4], jfg.RenderSettings(
            outputs="image", **cases.FRAME_BASE, **cases.SHADOWS))["image"])
    for kw in (dict(outputs="full"),
               dict(outputs="image+diag", live_tile_cap=31,
                    shadow_query_tile_cap=24)):
        calls = {}
        out = render_frame(*pin[:3], pmats, pin[4], RenderSettings(
            **cases.FRAME_BASE, **cases.SHADOWS, **kw), kernels=_spy(calls))
        assert_image_bound(out["image"].numpy(), want)
        if kw["outputs"] != "full":
            check_bin_diag(out["bin_diag"])
            assert calls["shade_gbuffer"] == 1 and "shade" not in calls


def test_per_material_image_bindings_frame_matches_jax():
    """The config-2 cubes on a tuple of per-material image-space bindings,
    chosen per pixel by ``batch_material_ids``: cube 0 a MaterialTextures
    (level-0 bilinear), cube 1 a MaterialMips (trilinear at the pixel
    quad's LOD); the plain chain and the production frame (no live-tile
    compaction: these sample (H, W) images; K5), against the JAX
    package's frame at the golden bound."""
    from bibim_tpu.scene.camera import FreeLookCamera as JCamera
    from bibim_tpu.scene.cube import CubeScene as JCubeScene

    cases.cap_threads()
    w, h = 256, 128
    alb0, alb1 = _img(8, 64, 64), _img(9, 32, 32)

    def neutral(rgba):
        return np.tile(np.asarray(rgba, np.uint8), (4, 4, 1))

    flat = dict(metallic=neutral((30, 0, 0, 255)),
                roughness=neutral((180, 180, 180, 255)),
                ao=neutral((255, 255, 255, 255)),
                normal=neutral((128, 128, 255, 255)),
                height=neutral((0, 0, 0, 255)))
    jtex = jfg.MaterialTextures(albedo=jnp.asarray(alb0),
                                **{k: jnp.asarray(v) for k, v in flat.items()})
    jmips = jfg.MaterialMips(
        albedo=jtx.build_mip_atlas(j_mip_pyramid(alb1)),
        **{k: jtx.build_mip_atlas([v]) for k, v in flat.items()})
    cam = JCamera()
    vb = jfg.ViewBlock(view=jnp.asarray(cam.get_view_matrix()),
                       proj=jm3.perspective(60.0, w / h, 0.1, 1000.0),
                       view_pos=jnp.asarray(cam.pos),
                       enable_normal_map=jnp.int32(0))
    fp = jfg.FrameParams(enable_tone_mapping=jnp.int32(1),
                         exposure=jnp.float32(1.0))
    base = dict(width=w, height=h, batch_material_ids=(0, 1),
                show_gizmo=False, show_lights=False, max_candidates=512,
                overflow_cap=64, span_cap=64, xla_cap=2048)
    jscene = JCubeScene().scene_data()
    want = np.asarray(jfg.render_frame(
        jscene, vb, fp, (jtex, jmips), None,
        jfg.RenderSettings(outputs="image", **base))["image"])
    pmats = interop.materials((jtex, jmips), device="cpu")
    assert isinstance(pmats[0], MaterialTextures)
    assert isinstance(pmats[1], MaterialMips)
    pin = (interop.scene_data(jscene, device="cpu"),
           interop.view_block(vb, device="cpu"),
           interop.frame_params(fp, device="cpu"))
    for kw in (dict(outputs="full"),
               dict(outputs="image+diag", live_tile_cap=20,
                    raster_tile_cap=24)):
        out = render_frame(*pin, pmats, None, RenderSettings(**base, **kw))
        assert_image_bound(out["image"].numpy(), want)
    assert not fg._planar_materials(pmats)
    # Each cube shows its own binding: swapping the ids changes the frame.
    swap = render_frame(*pin, pmats, None, RenderSettings(
        **dict(base, batch_material_ids=(1, 0)), outputs="image"))
    assert not np.array_equal(swap["image"].numpy(), want)


def test_cube_material_textures_binding():
    """``cube_material_tables(with_mips=False)``: one MaterialTextures per
    albedo, its maps the albedo and the 4×4 neutral maps of the JAX
    package's ``cube_scene_materials(with_mips=False)``."""
    albedos = (_img(10, 16, 16), _img(11, 8, 8))
    mats = cube_material_tables(albedos, device="cpu", with_mips=False)
    assert len(mats) == 2 and all(isinstance(m, MaterialTextures)
                                  for m in mats)
    for m, a in zip(mats, albedos):
        np.testing.assert_array_equal(m.albedo.numpy(), a)
        assert tuple(m.normal[0, 0].tolist()) == (128, 128, 255, 255)
        assert tuple(m.roughness[0, 0].tolist()) == (180, 180, 180, 255)
    fg.check_supported(RenderSettings(), mats)


def test_cube_scene_material_textures_real_albedos():
    """``cube_scene_materials(with_mips=False)`` on uv_debug.png and
    texture.jpg byte-equal to the JAX package's (skips without them)."""
    from bibim_tpu.scene.cube import cube_scene_materials as j_materials
    from bibim_tpu.utils.config import get_resource_root

    root = get_resource_root()
    if not root.common("uv_debug.png").is_file():
        pytest.skip("uv_debug.png not found (resource root "
                    f"{root.common_root})")
    from bibim_tpu_torch.scene.cube import cube_scene_materials

    want = j_materials(with_mips=False)
    got = cube_scene_materials(device="cpu", with_mips=False)
    for g, w in zip(got, want):
        for f in MaterialTextures._fields:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)), f)


def test_bindings_check_supported():
    """Every binding render_frame takes passes ``check_supported``; a tuple
    mixing table kinds does not (the JAX package fails on it too)."""
    jt = jtq.build_quad_tables(cases.material_maps(), block_threshold=1024)
    pt = interop.materials(jt, device="cpu")
    pq = interop.materials(jtq.build_mip_quad_tables(_mip_maps(1)),
                           device="cpu")
    tex = cases.checker_textures()
    s = RenderSettings()
    for m in (pt, pq, tex, (tex, tex), (pt, pq)):
        fg.check_supported(s, m)
    with pytest.raises(NotImplementedError):
        fg.check_supported(s, pt + pq)
    with pytest.raises(NotImplementedError):
        fg.check_supported(s, ())


def test_triangle_golden():
    """golden_configs' triangle_pbr_128x64 through the port: TriangleScene
    on the checker MaterialTextures binding (no asset needed)."""
    out = render_frame(
        TriangleScene(device="cpu").scene_data(), cases.golden_view(128, 64),
        cases.golden_params(), cases.checker_textures(), None,
        RenderSettings(width=128, height=64, outputs="image+diag"))
    check_bin_diag(out["bin_diag"])
    img = out["image"].numpy()
    assert (img > 0).any(axis=-1).mean() > 0.01
    assert_image_bound(img, cases.golden_png("triangle_pbr_128x64"))


class _MaterialSet:
    """A stand-in PBR material set: seeded mip chains per map type."""

    def __init__(self, seed):
        self.seed = seed

    def get_pbr_map_or_default(self, index, map_type):
        n = 16 if int(map_type) % 2 else 8
        img = _img(self.seed * 10 + int(map_type) + index, n, n)
        return j_mip_pyramid(img)


def test_material_bindings_from_set_match_jax():
    """``material_textures_from_set``, ``material_mip_quads_from_set`` and
    ``material_mips_from_set`` equal the JAX package's bindings carried
    across by ``interop.materials``."""
    from bibim_tpu_torch.pipeline import (
        material_mip_quads_from_set,
        material_mips_from_set,
        material_textures_from_set,
    )

    mset = _MaterialSet(2)
    for jfn, pfn in ((jfg.material_textures_from_set,
                      material_textures_from_set),
                     (jfg.material_mips_from_set, material_mips_from_set),
                     (jfg.material_mip_quads_from_set,
                      material_mip_quads_from_set)):
        want = interop.materials(jfn(mset, 1), device="cpu")
        got = pfn(mset, 1, device="cpu")
        assert type(got) is type(want)
        flat_w = jax.tree_util.tree_leaves(want)
        flat_g = jax.tree_util.tree_leaves(got)
        assert len(flat_w) == len(flat_g)
        for g, w in zip(flat_g, flat_w):
            if isinstance(w, torch.Tensor):
                assert torch.equal(g, w)
            else:
                assert g == w
