"""The port's CUDA kernels vs their plain PyTorch versions on the GPU.

Every test here but the input-validation one needs an NVIDIA GPU and nvcc
(marker ``cuda``) and skips without one. The file imports no JAX, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from bibim_tpu_torch import _build
from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused, sort
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading import (
    shade_sampled,
    shade_sampled_plain,
    shade_tonemap,
    shade_tonemap_plain,
)
from bibim_tpu_torch.pipeline import (
    KERNELS,
    PLAIN,
    FrameParams,
    RenderSettings,
    ViewBlock,
    make_overlay_resources,
    render_frame,
)
from bibim_tpu_torch.pipeline.framegraph import (
    _composite_light_spheres,
    _light_sphere_planar_soup,
)
from bibim_tpu_torch.ops.geometry import assemble_scene_planar
from bibim_tpu_torch.ops.raster import triangle_setup, triangle_setup_planar
from bibim_tpu_torch.scene.camera import FreeLookCamera
from bibim_tpu_torch.scene.lights import Lights
from bibim_tpu_torch.scene.meshgen import generate_uv_sphere_mesh
from bibim_tpu_torch.scene.scene import SceneData, batch_from_mesh
from bibim_tpu_torch.scene.shaderball import (
    ground_plane_batch,
    shaderball_lights,
)

W, H = 512, 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frame(dev):
    mesh = generate_uv_sphere_mesh(1.0, 48, 32)
    model = np.asarray(m3.translate([0.0, -0.3, 3.0]))
    scene = SceneData(batches=(batch_from_mesh(mesh, model, device=dev),
                               ground_plane_batch(dev)),
                      lights=shaderball_lights(dev))
    cam = FreeLookCamera()
    vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix(), device=dev),
                   proj=m3.perspective(60.0, W / H, 0.1, 1000.0, device=dev),
                   view_pos=torch.as_tensor(cam.pos, device=dev),
                   enable_normal_map=torch.tensor(1, device=dev))
    rng = np.random.default_rng(0)
    maps = {s: rng.integers(0, 256, (64, 64, 1), dtype=np.uint8)
            for s in ("metallic", "roughness", "ao")}
    maps.update({s: rng.integers(0, 256, (16, 16, 1), dtype=np.uint8)
                 for s in ("alb_r", "alb_g", "alb_b", "nrm_x", "nrm_y",
                           "nrm_z", "height")})
    mats = tq.build_quad_tables(maps, block_threshold=1024, device=dev)
    fp = FrameParams(torch.tensor(1, device=dev),
                     torch.tensor(1.0, device=dev))
    return scene, vb, fp, mats


def _setup(frame):
    scene, vb, _, _ = frame
    soup = assemble_scene_planar(scene.batches, vb.view, vb.proj)
    setup = triangle_setup_planar(soup.clip, W, H)
    return fused.build_record_table_planar(setup, soup), setup


def test_wrappers_validate_inputs():
    """Wrong dtypes and shapes raise before any launch (any device)."""
    with pytest.raises(ValueError):
        sort.sort_keys(torch.zeros(8, dtype=torch.float32))
    rec = torch.zeros((4, fused.REC_CH))
    i1 = torch.zeros(1, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.raster_tiles(rec, i1, i1, i1, ids, ids, ids,
                           torch.zeros((2, 16)), 1, 2, 8)  # float keys
    with pytest.raises(ValueError):
        fused.raster_tiles(rec[:, :60].contiguous(), i1, i1, i1, ids, ids,
                           ids, torch.zeros((2, 16), dtype=torch.int32), 1,
                           2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sort_kernel_matches_torch_sort(dev, dtype):
    gen = torch.Generator().manual_seed(1)
    hi = 1 << 30 if dtype == torch.int32 else 1 << 50
    for n in (1, 2, 100, 2048, 2049, 5000, 70000, 300000):
        keys = torch.randint(0, hi, (n,), generator=gen, dtype=dtype).to(dev)
        before = sort.sort_keys.launches
        got = sort.sort_keys(keys)
        torch.cuda.synchronize()
        assert torch.equal(got, sort.sort_keys_plain(keys)), n
        assert sort.sort_keys.launches == before + (n > 1)


def _route_edge(itemsize: int, one_launch) -> int:
    """The most keys K3 sorts on a route: ``one_launch(cluster size)``
    says whether a key count is on it."""
    lib = _build.library()
    lo, hi = 2, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if one_launch(lib.bb_sort_cluster(mid, itemsize)) \
            else (lo, mid)
    return lo


def _sort_keys_of(kind: str, n: int, dtype, gen):
    if kind == "random":
        hi = 1 << 30 if dtype == torch.int32 else 1 << 62
        return torch.randint(-hi, hi, (n,), generator=gen, dtype=dtype)
    if kind == "constant_digits":  # only digits 0 and 1 vary
        return torch.randint(0, 1 << 16, (n,), generator=gen,
                             dtype=dtype) + (5 << 24)
    if kind == "pairs":  # (tile, tri) keys with a sentinel tail, nt = 2025
        tile = torch.randint(0, 2026, (n,), generator=gen, dtype=dtype)
        tile[: n // 3] = 2025
        tri = torch.randint(0, 1 << 14, (n,), generator=gen, dtype=dtype)
        shift = 14 if dtype == torch.int32 else 49
        return (tile << shift) | tri
    return torch.full((n,), -77, dtype=dtype)  # all equal


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "constant_digits", "pairs",
                                  "all_equal"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sort_kernel_sizes_and_launches(dev, dtype, kind):
    """K3 bit-equal to torch.sort at every route's edge (one block, one
    cluster of up to 16 blocks, many blocks) and at the paths' sizes, with
    at most 2 + (non-constant digits) device launches per sort: 1 on the
    one-cluster route, 2 on the many-block one."""
    gen = torch.Generator().manual_seed(5)
    size = torch.empty((), dtype=dtype).element_size()
    one = _route_edge(size, lambda c: c == 1)
    cluster = _route_edge(size, lambda c: c > 0)
    assert cluster >= 8 * one  # clusters of 8 and more launch
    for n in (0, 1, 2, one, one + 1, 85_540, 320_064, cluster, cluster + 1,
              1_327_108):
        keys = _sort_keys_of(kind, n, dtype, gen).to(dev)
        before = sort.sort_keys.device_launches
        got = sort.sort_keys(keys)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.sort(keys).values), n
        launched = sort.sort_keys.device_launches - before
        plan = sort.digit_plan(keys.cpu())
        assert launched == (0 if n <= 1 else 1 if n <= cluster else 2), n
        assert launched <= 2 + len(plan), (n, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sort_kernel_every_route(dev, dtype):
    """Every route K3 can take for a key count (many blocks, one cluster
    of 1-16 blocks) sorts bit-equal to torch.sort; a route that cannot
    hold the keys raises."""
    lib = _build.library()
    gen = torch.Generator().manual_seed(9)
    size = torch.empty((), dtype=dtype).element_size()
    for n in (2, 4096, 32_769, 85_540):
        keys = _sort_keys_of("pairs", n, dtype, gen).to(dev)
        want = torch.sort(keys).values
        routes = [r for r in (0, 1, 2, 4, 8, 16)
                  if lib.bb_sort_work_bytes(n, size, r) >= 0]
        assert 0 in routes and len(routes) > 1, (n, routes)
        for r in routes:
            got = sort.sort_keys(keys, route=r)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, r)
    with pytest.raises(RuntimeError):
        sort.sort_keys(keys, route=3)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
def test_raster_kernel_cluster_split_bit_equal(dev, frame, cluster):
    """K1 with a slot's candidates split across 1-8 blocks of a cluster
    equals its plain version on windows past the split threshold full of
    ties: every triangle four times (the last copy must win), then the
    same slots continuing their own keys (every winner ties the initial
    key), and with empty parts (short windows)."""
    rec, setup = _setup(frame)
    sorted_tri, starts, counts, big_ids, n_big, diag, ty, tx = \
        fused.bin_pairs(setup, W, H, 8, 128, span_cap=16, overflow_cap=32,
                        max_candidates=512)
    t, n = rec.shape[0], 4
    copies = lambda x: torch.stack([x + j * t for j in range(n)],
                                   1).reshape(-1)  # noqa: E731
    nb = int(n_big[0])
    big = torch.cat([copies(big_ids[:nb]), torch.full(
        (n * 32 - n * nb,), -1, dtype=torch.int32, device=dev)])
    ids = torch.arange(ty * tx, dtype=torch.int32, device=dev)
    # Copy j keeps the coverage and depth channels and renumbers _ID to
    # id + j·T, so the plane idf tells which copy won.
    recs = [rec.clone() for _ in range(n)]
    for j, r in enumerate(recs):
        live = r[:, fused._ID] > 0
        r[live, fused._ID] += j * t
    args = (torch.cat(recs), big,
            torch.tensor([n * nb], dtype=torch.int32, device=dev),
            copies(sorted_tri), ids, (n * starts).contiguous(),
            (n * counts).contiguous())
    assert int(args[6].max()) >= 2 * fused.CLUSTER_MIN_PART
    # At 8 blocks, parts of at least 64 candidates: slots split several
    # ways leaving parts empty, and slots that rank 0 scans alone.
    total = args[6] + n * nb
    part = torch.clamp((total + 7) // 8, min=fused.CLUSTER_MIN_PART)
    parts = (total + part - 1) // part
    assert bool(((parts > 1) & (parts < 8)).any())
    assert bool((parts <= 1).any())
    init = torch.zeros((ty * tx, 1024), dtype=torch.int32, device=dev)
    if cluster is None:
        assert fused.raster_cluster(ids.shape[0], n * 512) == 8
    for _ in range(2):
        before = fused.raster_tiles.launches
        zk, f = fused.raster_tiles(*args, init, tx, 8, 128,
                                   max_count=n * 512, cluster=cluster)
        zk_p, f_p = fused.raster_tiles_plain(*args, init, tx, 8, 128)
        torch.cuda.synchronize()
        assert fused.raster_tiles.launches == before + 1
        idf = fused._OUT_FIELDS.index("idf")
        assert torch.equal(zk, zk_p) and torch.equal(f[idf], f_p[idf])
        assert float((f - f_p).abs().max()) <= 1e-3
        hit = f_p[idf] >= 0.5
        assert float(hit.float().mean()) > 0.2
        assert bool((f_p[idf][hit] > (n - 1) * t).all())  # last copies
        init = zk_p


@pytest.mark.cuda
def test_raster_kernel_instanced_passes_bit_equal(dev):
    """Every K1 call of a multi-pass instanced frame (config 4's default
    raster mode at a small size) equals its plain version at every
    cluster size, and the frame equals the all-plain render."""
    from bibim_tpu_torch.scene.shaderball import (
        ShaderBallScene,
        instanced_camera,
    )

    scene = ShaderBallScene(num_instances=64, device=dev,
                            ball_mesh=generate_uv_sphere_mesh(100.0, 24, 13))
    cam = instanced_camera()
    vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix(), device=dev),
                   proj=m3.perspective(60.0, W / H, 0.1, 1000.0, device=dev),
                   view_pos=torch.as_tensor(cam.pos, device=dev),
                   enable_normal_map=torch.tensor(0, device=dev))
    fp = FrameParams(torch.tensor(1, device=dev),
                     torch.tensor(1.0, device=dev))
    mats = tq.build_quad_tables(
        {s: np.full((16, 16, 1), 128, np.uint8) for s in tq.SLOTS},
        device=dev)
    s = RenderSettings(width=W, height=H, outputs="image+diag",
                       show_gizmo=False, show_lights=False, pair_sampling=0,
                       max_candidates=128, raster_passes=8,
                       dense_tile_cap=128,
                       live_tile_cap=128, raster_tile_cap=128,
                       span_mid_cap=4096)
    calls = []

    def capture(*a, **k):
        calls.append((a, k))
        return fused.raster_tiles(*a, **k)

    out = render_frame(scene.scene_data(), vb, fp, mats, None, s,
                       kernels=KERNELS._replace(raster=capture))
    ref = render_frame(scene.scene_data(), vb, fp, mats, None, s,
                       kernels=PLAIN)
    torch.cuda.synchronize()
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    assert torch.equal(out["image"], ref["image"])
    assert len(calls) == 8
    idf = fused._OUT_FIELDS.index("idf")
    for a, k in calls:
        want = fused.raster_tiles_plain(*a, **k)
        for c in fused.CLUSTER_SIZES:
            zk, f = fused.raster_tiles(*a, **k, cluster=c)
            torch.cuda.synchronize()
            assert torch.equal(zk, want[0]) and torch.equal(f[idf],
                                                            want[1][idf])
            assert float((f - want[1]).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(max_candidates=512),
    dict(max_candidates=48, passes=4, raster_tile_cap=96,
         dense_tile_cap=64, span_mid_cap=1024),
], ids=["single_pass", "multipass_compacted"])
def test_raster_kernel_bit_equal(dev, frame, kw):
    rec, setup = _setup(frame)
    args = dict(overflow_cap=64, span_cap=16, **kw)
    before = fused.raster_tiles.launches
    px, zk, diag = fused.raster_fused(rec, setup, W, H, **args)
    px_p, zk_p, diag_p = fused.raster_fused(
        rec, setup, W, H, raster=fused.raster_tiles_plain,
        sort=sort.sort_keys_plain, **args)
    torch.cuda.synchronize()
    assert fused.raster_tiles.launches > before
    for k in range(4):
        assert int(diag[k]) == 0 == int(diag_p[k])
    assert torch.equal(zk, zk_p)
    assert float((px.tri_id >= 0).float().mean()) > 0.3
    for a, b in zip(px, px_p):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def _planes(dev, seed, shape=(10, 1024)):
    gen = torch.Generator().manual_seed(seed)

    def p(lo, hi):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(dev)

    return p


def _assert_close_rel(got, want):
    """tests/test_shading_pallas.py _assert_close_rel."""
    for g, w in zip(got, want):
        diff = ((g - w).abs() / (1.0 + w.abs())).cpu().numpy()
        assert (diff > 5e-5).mean() < 1e-3 and diff.max() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("deferred,with_vis", [
    (True, False), (False, False), (True, True), (False, True),
], ids=["deferred", "forward", "deferred_vis", "forward_vis"])
def test_shade_kernel_matches_plain(dev, frame, deferred, with_vis):
    _, _, _, mats = frame
    lights = shaderball_lights(dev)
    p = _planes(dev, 5)
    u, v = p(-2, 3), p(-2, 3)
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    tangent = (p(-1, 1), p(-1, 1), p(-1, 1))
    valid = p(0, 1) > 0.3
    vis = dict(vis_plane=p(0, 1), vis_light=0) if with_vis else {}
    for nm in (0, 1):
        args = (mats, u, v, world, normal, tangent, valid, lights,
                torch.tensor([0.0, 1.0, -3.0], device=dev),
                torch.tensor(nm, device=dev))
        got = shade_sampled(*args, quantize=deferred, **vis)
        want = shade_sampled_plain(*args, quantize=deferred, **vis)
        torch.cuda.synchronize()
        _assert_close_rel(got, want)
        if with_vis:
            plain = shade_sampled(*args, quantize=deferred)
            assert not torch.equal(got[0], plain[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(), dict(vis=True), dict(ambient=True), dict(vis=True, ambient=True),
    dict(quantize=False, tonemap=False, vis=True, ambient=True),
    dict(no_lights=True),
], ids=["defaults", "vis", "ambient", "vis_ambient", "frame_options",
        "no_lights"])
def test_gbuffer_shade_kernel_matches_plain(dev, kw):
    p = _planes(dev, 7, (10, 1000))
    lights = shaderball_lights(dev)
    if kw.get("no_lights"):
        lights = lights._replace(**{f: getattr(lights, f)[:0]
                                    for f in lights._fields})
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    albedo = (p(0, 1), p(0, 1), p(0, 1))
    args = (world, normal, albedo, p(0, 1), p(0.05, 1), p(0, 1),
            p(0, 1) > 0.3, lights, torch.tensor([0.0, 1.0, -3.0], device=dev),
            torch.tensor(1, device=dev), torch.tensor(1.3, device=dev))
    opts = dict(quantize=kw.get("quantize", True),
                tonemap=kw.get("tonemap", True))
    if kw.get("vis"):
        opts.update(vis_plane=p(0, 1), vis_light=1)
    if kw.get("ambient"):
        opts["ambient"] = (p(0, 0.2), p(0, 0.2), p(0, 0.2))
    before = shade_tonemap.launches
    got = shade_tonemap(*args, **opts)
    want = shade_tonemap_plain(*args, **opts)
    torch.cuda.synchronize()
    assert shade_tonemap.launches == before + 1
    _assert_close_rel(got, want)


@pytest.mark.cuda
def test_sample_kernels_bit_equal(dev, frame):
    """K6 (block table) and K7 (quad table) equal their plain versions,
    and sample_material routes to them."""
    _, _, _, mats = frame
    p = _planes(dev, 9, (12, 1024))
    u, v = p(-2, 3), p(-2, 3)
    block = next(t for t in mats if isinstance(t, tq.BlockTable))
    quad = next(t for t in mats if isinstance(t, tq.QuadTable))
    for kern, plain, table in (
            (tq.sample_table_block_kernel, tq.sample_table_block, block),
            (tq.sample_table_small, tq.sample_table_small_plain, quad)):
        got, want = kern(table, u, v), plain(table, u, v)
        torch.cuda.synchronize()
        assert set(got) == set(want) == set(table.present)
        for slot in want:
            assert torch.equal(got[slot], want[slot]), slot
    before = (tq.sample_table_block_kernel.launches,
              tq.sample_rows_small.launches)
    routed = tq.sample_material(mats, u, v, KERNELS)
    plain = tq.sample_material(mats, u, v, PLAIN)
    assert (tq.sample_table_block_kernel.launches,
            tq.sample_rows_small.launches) == (before[0] + 1, before[1] + 1)
    for slot in tq.SLOTS:
        assert torch.equal(routed[slot], plain[slot]), slot
    # A row index outside the table samples 0, as the one-hot select does.
    idx = torch.tensor([[-1, 0, quad.quads.shape[0]]], dtype=torch.int32,
                       device=dev)
    t = torch.full((1, 3), 0.25, device=dev)
    got = tq.sample_rows_small(quad.quads, idx, t, t, quad.present)
    want = tq.sample_rows_small_plain(quad.quads, idx, t, t, quad.present)
    for slot in want:
        assert torch.equal(got[slot], want[slot])
        assert float(got[slot][0, 0]) == 0.0 == float(got[slot][0, 2])


def _smooth_uv(dev, seed, nt=24, e_lo=-3.0, e_hi=9.0, base=256.0):
    """Tiled (NT, 8·128) uv: a rotated affine map per tile at 2^e texels
    per pixel of a ``base``² level 0, so the LOD spans the pyramid."""
    rng = np.random.default_rng(seed)
    py, px = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    s = (2.0 ** rng.uniform(e_lo, e_hi, nt) / base)[:, None]
    ang = rng.uniform(0, 2 * np.pi, nt)[:, None]
    u = rng.uniform(-2, 2, nt)[:, None] + s * (np.cos(ang) * px
                                               - np.sin(ang) * py)
    v = rng.uniform(-2, 2, nt)[:, None] + s * (np.sin(ang) * px
                                               + np.cos(ang) * py)
    mat = rng.integers(0, 2, u.shape).astype(np.int32)
    return tuple(torch.as_tensor(a).to(dev) for a in (
        u.astype(np.float32), v.astype(np.float32), mat))


def _cube_tables(dev, max_levels):
    """A cube-like binding of two materials: seeded 256² and 128² albedo
    pyramids (one MipBlockMulti; ``max_levels`` cuts them at a 4-divisible
    level, leaving no stored last parent) and 4×4 metallic / roughness /
    ao maps (one routed single-level MipQuadMulti)."""
    rng = np.random.default_rng(2)
    mats = []
    for n in (256, 128):
        mips = tq.build_mip_pyramid(
            rng.integers(0, 256, (n, n, 3), dtype=np.uint8), max_levels)
        maps = {s: [m[:, :, k:k + 1] for m in mips]
                for k, s in enumerate(("alb_r", "alb_g", "alb_b"))}
        maps.update({s: [rng.integers(0, 256, (4, 4, 1), dtype=np.uint8)]
                     for s in ("metallic", "roughness", "ao")})
        mats.append(tq.build_mip_block_tables(maps, device=dev))
    return tq.merge_mip_block_materials(tuple(mats))


@pytest.mark.cuda
@pytest.mark.parametrize("max_levels", [None, 4],
                         ids=["stored_parent", "true_last_level"])
def test_mip_block_kernel_bit_equal(dev, max_levels):
    """K8 equals its plain version on a pyramid with and without a stored
    last parent, at LODs across every level (the deepest included), and
    sample_material_mips_multi routes to K8 and K7."""
    mats = _cube_tables(dev, max_levels)
    block = mats[0]
    assert block.last_parent == ((max_levels is None),) * 2
    u, v, mat = _smooth_uv(dev, 3)
    before = tq.sample_mip_block_kernel.launches
    got = tq.sample_mip_block_kernel(block, mat, u, v)
    want = tq.sample_mip_block(block, mat, u, v)
    torch.cuda.synchronize()
    assert tq.sample_mip_block_kernel.launches == before + 1
    for slot in want:
        assert torch.equal(got[slot], want[slot]), slot
    l0 = tq._mip_block_geometry(block, mat, u, v, 8, 128)["l0"]
    deepest = l0 == torch.tensor([len(h) - 1 for h in block.heights],
                                 device=dev)[mat.long()]
    assert len(l0.unique()) == max(len(h) for h in block.heights)
    assert bool(deepest.any())
    before = (tq.sample_mip_block_kernel.launches,
              tq.sample_rows_small.launches)
    routed = tq.sample_material_mips_multi(mats, mat, u, v, 8, 128, KERNELS)
    plain = tq.sample_material_mips_multi(mats, mat, u, v, 8, 128, PLAIN)
    assert (tq.sample_mip_block_kernel.launches,
            tq.sample_rows_small.launches) == (before[0] + 1, before[1] + 1)
    for slot in tq.SLOTS:
        assert torch.equal(routed[slot], plain[slot]), slot


@pytest.mark.cuda
@pytest.mark.parametrize("deferred", [True, False],
                         ids=["deferred", "forward"])
def test_shade_kernel_mip_groups_bit_equal(dev, deferred):
    """K2 with the mip-block group and the material-routed small group
    equals its plain version."""
    mats = _cube_tables(dev, None)
    u, v, mat = _smooth_uv(dev, 4, nt=10)
    p = _planes(dev, 6)
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    tangent = (p(-1, 1), p(-1, 1), p(-1, 1))
    valid = p(0, 1) > 0.3
    for nm in (0, 1):
        args = (mats, u, v, world, normal, tangent, valid,
                shaderball_lights(dev),
                torch.tensor([0.0, 1.0, -3.0], device=dev),
                torch.tensor(nm, device=dev))
        kw = dict(quantize=deferred, mat_id=mat)
        got = shade_sampled(*args, **kw)
        want = shade_sampled_plain(*args, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(), dict(gbuffer_viz=2), dict(gbuffer_viz=3), dict(enable_ibl=True),
], ids=["frame", "albedo_view", "mrha_view", "ibl"])
def test_cube_frame_kernels_vs_plain(dev, extra):
    """Config 2's frame (and its G-buffer views, and IBL on its mip
    binding) through the kernels equals the all-plain render."""
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.scene.cube import CubeScene

    scene = CubeScene(device=dev)
    mats = _cube_tables(dev, None)
    cam = FreeLookCamera()
    vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix(), device=dev),
                   proj=m3.perspective(60.0, W / H, 0.1, 1000.0, device=dev),
                   view_pos=torch.as_tensor(cam.pos, device=dev),
                   enable_normal_map=torch.tensor(0, device=dev))
    fp = FrameParams(torch.tensor(1, device=dev),
                     torch.tensor(1.0, device=dev))
    s = RenderSettings(width=W, height=H, outputs="image+diag",
                       show_gizmo=False, show_lights=False,
                       batch_material_ids=scene.material_ids,
                       max_candidates=64, live_tile_cap=96,
                       raster_tile_cap=96, **extra)
    ibl = make_ibl_sh(device=dev)
    kernel_fns = [fused.raster_tiles, sort.sort_keys]
    kernel_fns += ([tq.sample_mip_block_kernel, tq.sample_rows_small]
                   if s.enable_ibl or s.gbuffer_viz != 5 else [shade_sampled])
    counts = [f.launches for f in kernel_fns]
    out = render_frame(scene.scene_data(), vb, fp, mats, None, s, ibl=ibl)
    ref = render_frame(scene.scene_data(), vb, fp, mats, None, s, ibl=ibl,
                       kernels=PLAIN)
    torch.cuda.synchronize()
    assert all(f.launches > c for f, c in zip(kernel_fns, counts))
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    d = (out["image"].int() - ref["image"].int()).abs()
    assert int(d.max()) <= 2
    assert float((d > 0).any(dim=-1).float().mean()) <= 1e-3
    assert float((out["image"] > 0).any(dim=-1).float().mean()) > 0.05


@pytest.mark.cuda
def test_overlay_kernel_bit_equal(dev, frame):
    scene, vb, _, _ = frame
    rec, setup = _setup(frame)
    _, zkey, _ = fused.raster_fused(rec, setup, W, H, max_candidates=512)
    overlay = make_overlay_resources(dev, with_gizmo=False)
    lights = scene.lights._replace(pos=torch.tensor(
        [[0.3, 0.1, 2.2], [-0.4, -0.2, 3.1], [1.0, 0.3, 4.5]], device=dev))
    vp = m3.matmul(vb.proj, vb.view)
    s = RenderSettings(width=W, height=H)
    nt = s.tiles_x * s.tiles_y
    ldr = tuple(torch.rand((nt, 1024), device=dev) for _ in range(3))
    got, diag = _composite_light_spheres(ldr, zkey, lights, overlay, vp, s,
                                         KERNELS)
    want, _ = _composite_light_spheres(ldr, zkey, lights, overlay, vp, s,
                                       PLAIN)
    torch.cuda.synchronize()
    assert int(diag.dropped_tiles) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(bool((a != b).any()) for a, b in zip(got, ldr))
    assert _light_sphere_planar_soup(lights, overlay, vp).num_triangles > 0


@pytest.mark.cuda
@pytest.mark.parametrize("stretch", [
    dict(),
    dict(enable_shadows=True, shadow_fit_batches=(0,), shadow_size=512,
         shadow_tile_cap=256, shadow_query_tile_cap=120),
    dict(enable_ibl=True),
    dict(enable_shadows=True, shadow_fit_batches=(0,), enable_ibl=True),
], ids=["deferred", "shadows", "ibl", "shadows_ibl"])
def test_frame_kernels_vs_plain(dev, frame, stretch):
    from bibim_tpu_torch.ops.ibl import make_ibl_sh

    scene, vb, fp, mats = frame
    overlay = make_overlay_resources(dev, with_gizmo=False)
    s = RenderSettings(width=W, height=H, outputs="image+diag",
                       show_gizmo=False, max_candidates=256,
                       live_tile_cap=120, raster_tile_cap=128,
                       span_mid_cap=1024, **stretch)
    ibl = make_ibl_sh(device=dev)
    kernel_fns = [fused.raster_tiles, sort.sort_keys, fused.overlay_tiles]
    kernel_fns += ([shade_tonemap, tq.sample_table_block_kernel,
                    tq.sample_rows_small] if s.enable_ibl
                   else [shade_sampled])
    counts = [f.launches for f in kernel_fns]
    out = render_frame(scene, vb, fp, mats, overlay, s, ibl=ibl)
    ref = render_frame(scene, vb, fp, mats, overlay, s, ibl=ibl,
                       kernels=PLAIN)
    torch.cuda.synchronize()
    after = [f.launches for f in kernel_fns]
    assert all(a > b for a, b in zip(after, counts))
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    d = (out["image"].int() - ref["image"].int()).abs()
    assert int(d.max()) <= 2
    assert float((d > 0).any(dim=-1).float().mean()) <= 1e-3


_VARIANT_FN = {"earlyz": "raster_tiles_earlyz", "group_pair_cap":
               "raster_tiles_gw", "fine_bins": "raster_tiles_fine"}
_PLAIN_RASTERS = dict(raster=fused.raster_tiles_plain,
                      raster_earlyz=fused.raster_tiles_earlyz_plain,
                      raster_gw=fused.raster_tiles_gw_plain,
                      raster_fine=fused.raster_tiles_fine_plain,
                      sort=sort.sort_keys_plain)


def _assert_rasters_equal(a, b):
    px, zk, diag = a
    px_p, zk_p, diag_p = b
    for k in range(4):
        assert int(diag[k]) == int(diag_p[k])
    assert torch.equal(zk, zk_p)
    for x, y in zip(px, px_p):
        for u, w in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(earlyz=True, max_candidates=512),
    dict(earlyz=True, max_candidates=48, passes=4, raster_tile_cap=96,
         dense_tile_cap=64),
    dict(group_pair_cap=4096, max_candidates=512, raster_tile_cap=96),
    dict(group_pair_cap=64, max_candidates=512, raster_tile_cap=96),
    dict(fine_bins=True, max_candidates=512),
    dict(fine_bins=True, max_candidates=48, passes=4, raster_tile_cap=96,
         dense_tile_cap=64),
], ids=["earlyz", "earlyz_multipass", "group_window",
        "group_window_overflow", "fine_bins", "fine_bins_multipass"])
def test_raster_variant_kernels_bit_equal(dev, frame, kw):
    """K9, K10 and K11 through raster_fused: bit-equal to their plain
    versions (drops included), and to K1's frame where nothing drops."""
    rec, setup = _setup(frame)
    args = dict(overflow_cap=64, span_cap=16, **kw)
    fn = getattr(fused, next(v for k, v in _VARIANT_FN.items() if k in kw))
    before = fn.launches
    got = fused.raster_fused(rec, setup, W, H, **args)
    want = fused.raster_fused(rec, setup, W, H, **args, **_PLAIN_RASTERS)
    torch.cuda.synchronize()
    assert fn.launches > before
    _assert_rasters_equal(got, want)
    if int(got[2].dropped_cap) == 0:
        base = {k: v for k, v in args.items()
                if k not in ("earlyz", "group_pair_cap", "fine_bins")}
        _assert_rasters_equal(got, fused.raster_fused(rec, setup, W, H,
                                                      **base))
    else:
        assert "group_pair_cap" in kw


def _occluded_layers(dev, layers=8, cell=16):
    """Clip-space test geometry for K9's break: two near triangles (z 0.9,
    spanning the viewport: the overflow list) in front of ``layers`` grids
    of small far triangles (z 0.05-0.4), one per 16-px cell and layer."""
    tris = [[[-3.0, -3.0, 0.9, 1.0], [3.0, -3.0, 0.9, 1.0],
             [0.0, 5.0, 0.9, 1.0]]] * 2
    for layer in range(layers):
        z = 0.4 - 0.05 * layer
        for y0 in range(0, H, cell):
            for x0 in range(0, W, cell):
                c = [(x0 + 1, y0 + 1), (x0 + cell - 1, y0 + 1),
                     (x0 + 1, y0 + cell - 1)]
                tris.append([[2.0 * x / W - 1.0, 2.0 * y / H - 1.0, z, 1.0]
                             for x, y in c])
    clip = torch.tensor(tris, dtype=torch.float32, device=dev).reshape(-1, 4)
    idx = torch.arange(clip.shape[0], dtype=torch.int32,
                       device=dev).reshape(-1, 3)
    setup = triangle_setup(clip, idx, W, H)
    z3 = torch.zeros((clip.shape[0], 3), device=dev)
    rec = fused.build_record_table(setup, idx, z3[:, :2], z3, z3, clip[:, :3],
                                   z3)
    return rec, setup


@pytest.mark.cuda
def test_earlyz_kernel_break_fires(dev):
    """K9's break on the card: behind a near occluder (the overflow list)
    every window candidate is farther, so each tile stops after its first
    window round; the chunk counter shows the skip, and zkey, okey and
    every plane equal the plain version's (which scans everything) and
    K1's frame."""
    rec, setup = _occluded_layers(dev)
    calls = []

    def capture(*a, **k):
        calls.append((a, k))
        return fused.raster_tiles_earlyz(*a, **k)

    kw = dict(max_candidates=512, overflow_cap=8, span_cap=4)
    got = fused.raster_fused(rec, setup, W, H, earlyz=True,
                             raster_earlyz=capture, **kw)
    base = fused.raster_fused(rec, setup, W, H, **kw)
    a, k = calls[0]
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    out = fused.raster_tiles_earlyz(*a, **k, stats=stats)
    want = fused.raster_tiles_earlyz_plain(*a, **k)
    torch.cuda.synchronize()
    for x, y in zip(out, want):
        assert torch.equal(x, y)
    _assert_rasters_equal(got, base)
    scanned, present = stats.tolist()
    assert 0 < scanned <= present // 2, (scanned, present)
    assert bool((got[0].tri_id >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(early_z=True), dict(fine_bins=True),
    dict(group_pair_cap=2048, raster_passes=1, max_candidates=256)],
    ids=["early_z", "fine_bins", "group_pair_cap"])
def test_variant_frames_vs_plain(dev, frame, extra):
    """render_frame on K9 / K10 / K11 against the all-plain render."""
    scene, vb, fp, mats = frame
    s = RenderSettings(**{**dict(
        width=W, height=H, outputs="image+diag", show_gizmo=False,
        show_lights=False, max_candidates=64, raster_passes=4,
        dense_tile_cap=64, live_tile_cap=120, raster_tile_cap=128,
        span_mid_cap=1024), **extra})
    fn = getattr(fused, next(v for k, v in _VARIANT_FN.items()
                             if k in extra or (k == "earlyz"
                                               and "early_z" in extra)))
    before = fn.launches
    out = render_frame(scene, vb, fp, mats, None, s)
    ref = render_frame(scene, vb, fp, mats, None, s, kernels=PLAIN)
    torch.cuda.synchronize()
    assert fn.launches > before
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    assert torch.equal(out["image"], ref["image"])


# ---------------------------------------------------------------------------
# K2 and K5 after their redesign: the group layouts K2 is compiled for, the
# light counts around the kernels' 64-light shared-memory tile
# (csrc/shading.cuh LIGHT_TILE), valid-first reads and the fused tail.
# ---------------------------------------------------------------------------

def _odd_lights(dev, n=4):
    """``n`` lights cycling through a spot light, a spot light whose cone
    has no width, an unknown type (lit as a point) and a directional light
    with a zero direction."""
    gen = torch.Generator().manual_seed(n)

    def r(*shape):
        return torch.rand(shape, generator=gen)

    kinds = torch.tensor([1, 1, 3, 2], dtype=torch.int32).repeat(n)[:n]
    d = r(n, 3) * 2 - 1
    d[3::4] = 0.0
    inner = 0.8 + 0.2 * r(n)
    outer = inner - 0.1 * r(n)
    outer[1::4] = inner[1::4]
    lights = Lights(pos=r(n, 3) * 6 - 3, type=kinds, dir=d,
                    intensity=1 + 4 * r(n), color=r(n, 3),
                    inner_cutoff=inner, outer_cutoff=outer)
    return Lights(*(t.to(dev) for t in lights))


def _garbage(valid, x):
    """``x`` with NaN / +inf / -inf at the miss pixels."""
    g = torch.tensor([float("nan"), float("inf"), float("-inf")],
                     device=x.device)
    idx = torch.arange(x.numel(), device=x.device).reshape(x.shape) % 3
    return torch.where(valid, x, g[idx])


def _k2_binding(dev, binding):
    """(tables, u, v, mat_id, shape, the instantiation K2 must pick:
    csrc/shade.cu shade_layout)."""
    from bibim_tpu_torch.scene.cube import cube_material_tables, seeded_albedos

    rng = np.random.default_rng(11)
    if binding in ("mip_routed", "generic_mip"):
        mats = (cube_material_tables(seeded_albedos(3, (64, 128)),
                                     device=dev)
                if binding == "mip_routed" else _cube_tables(dev, None))
        u, v, mat = _smooth_uv(dev, 9, nt=10)
        return mats, u, v, mat, u.shape, 2 if binding == "mip_routed" else 0
    maps = {s: rng.integers(0, 256, (64, 64, 1), dtype=np.uint8)
            for s in ("metallic", "roughness", "ao")}
    maps.update({s: rng.integers(0, 256, (16, 16, 1), dtype=np.uint8)
                 for s in ("alb_r", "alb_g", "alb_b", "nrm_x", "nrm_y",
                           "nrm_z", "height")})
    if binding == "generic_quads":
        del maps["height"]
    mats = tq.build_quad_tables(maps, block_threshold=1024, device=dev)
    shape = (7, 999)  # n not a multiple of the block size
    gen = torch.Generator().manual_seed(12)
    u, v = (-2 + 5 * torch.rand(shape, generator=gen) for _ in range(2))
    return mats, u.to(dev), v.to(dev), None, shape, \
        1 if binding == "block_quad" else 0


@pytest.mark.cuda
@pytest.mark.parametrize("binding", ["block_quad", "mip_routed",
                                     "generic_quads", "generic_mip"])
def test_shade_kernel_layouts(dev, binding):
    """K2 on each group layout it is compiled for (configs 3/4: block +
    quad; config 2: mip block + routed quad) and on the generic
    instantiation: the kernel's layout pick; the kernel against its plain
    version (bit-equal on the mip bindings, whose plain sampling is the
    kernel's order) and against the generic instantiation (bit-equal);
    NaN / inf at the misses changes nothing; the fused fp16 + tone-map
    tail equals the torch tail."""
    import ctypes

    from bibim_tpu_torch.ops import shading

    mats, u, v, mat, shape, layout = _k2_binding(dev, binding)
    p = _planes(dev, 13, shape)
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    tangent = (p(-1, 1), p(-1, 1), p(-1, 1))
    valid = p(0, 1) > 0.3
    groups, _ = shading._groups(mats, u, v, mat, 8, 128)
    assert _build.library().bb_shade_layout(ctypes.byref(groups)) == layout
    tail = dict(quantize_hdr=True, tonemap=True,
                enable_tone_mapping=torch.tensor(1, device=dev),
                exposure=torch.tensor(1.3, device=dev))
    for nm in (0, 1):
        args = (mats, u, v, world, normal, tangent, valid,
                shaderball_lights(dev),
                torch.tensor([0.0, 1.0, -3.0], device=dev),
                torch.tensor(nm, device=dev))
        for kw in (dict(mat_id=mat), dict(tail, mat_id=mat)):
            got = shade_sampled(*args, **kw)
            want = shade_sampled_plain(*args, **kw)
            generic = shade_sampled(*args, generic=True, **kw)
            # A mip group's LOD takes the 2×2 quad's uv derivatives, so
            # a covered pixel reads its neighbours' uv (as the reference
            # does): there only the per-pixel planes get garbage.
            uv = (u, v) if mat is not None else (_garbage(valid, u),
                                                 _garbage(valid, v))
            dirty = shade_sampled(
                mats, *uv,
                *(tuple(_garbage(valid, c) for c in x)
                  for x in (world, normal, tangent)),
                *args[6:], **kw)
            torch.cuda.synchronize()
            if mat is not None:
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
            else:
                _assert_close_rel(got, want)
            for g, d, x in zip(got, dirty, generic):
                assert torch.equal(g, d)
                assert torch.equal(g, x)
                assert bool((g[~valid] == 0).all())
        hdr = shade_sampled(*args, mat_id=mat)
        fused = shade_sampled(*args, mat_id=mat, **tail)
        want = shading.hdr_tail(hdr, True, True, tail["enable_tone_mapping"],
                                tail["exposure"])
        torch.cuda.synchronize()
        for f, w in zip(fused, want):
            assert torch.equal(f, w)


@pytest.mark.cuda
@pytest.mark.parametrize("lights", ["none", "one", "shaderball", "odd",
                                    "one_tile", "tiles"])
@pytest.mark.parametrize("extra", ["plain", "vis_ambient"])
def test_gbuffer_shade_kernel_lights(dev, lights, extra):
    """K5 with 0, 1 and 3 (directional and point) lights, spot lights and
    the other kinds, a full light tile (64) and 200 lights restaged tile
    by tile; with and without the visibility and ambient planes; n not a
    multiple of the block size: against its plain version, NaN / inf at
    the misses changing nothing, the fused fp16 + tone-map tail equal to
    the torch tail."""
    from bibim_tpu_torch.ops import shading

    shape = (5, 1001)
    p = _planes(dev, 17, shape)
    ls = shaderball_lights(dev)
    ls = {"none": ls._replace(**{f: getattr(ls, f)[:0]
                                 for f in ls._fields}),
          "one": ls._replace(**{f: getattr(ls, f)[1:2]
                                for f in ls._fields}),
          "shaderball": ls, "odd": _odd_lights(dev),
          "one_tile": _odd_lights(dev, 64),
          "tiles": _odd_lights(dev, 200)}[lights]
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    albedo = (p(0, 1), p(0, 1), p(0, 1))
    mra = (p(0, 1), p(0.05, 1), p(0, 1))
    valid = p(0, 1) > 0.3
    tm, expo = torch.tensor(1, device=dev), torch.tensor(1.3, device=dev)
    opts = {}
    if extra == "vis_ambient":
        opts = dict(vis_plane=p(0, 1), vis_light=0,
                    ambient=(p(0, 0.2), p(0, 0.2), p(0, 0.2)))

    def run(fn, clean=True, **kw):
        planes = [*world, *normal, *albedo, *mra]
        o = dict(opts)
        if not clean:
            planes = [_garbage(valid, x) for x in planes]
            if "vis_plane" in o:
                o["vis_plane"] = _garbage(valid, o["vis_plane"])
                o["ambient"] = tuple(_garbage(valid, a)
                                     for a in o["ambient"])
        return fn(tuple(planes[0:3]), tuple(planes[3:6]),
                  tuple(planes[6:9]), *planes[9:12], valid, ls,
                  torch.tensor([0.0, 1.0, -3.0], device=dev), tm, expo,
                  **o, **kw)

    for q in (False, True):
        got = run(shade_tonemap, quantize=q, tonemap=q)
        want = run(shade_tonemap_plain, quantize=q, tonemap=q)
        dirty = run(shade_tonemap, clean=False, quantize=q, tonemap=q)
        torch.cuda.synchronize()
        _assert_close_rel(got, want)
        for g, d in zip(got, dirty):
            assert torch.equal(g, d)
            assert bool((g[~valid] == 0).all())
    hdr = run(shade_tonemap, quantize=False, tonemap=False)
    fused = run(shade_tonemap, quantize=True, tonemap=True)
    want = shading.hdr_tail(hdr, True, True, tm, expo)
    torch.cuda.synchronize()
    for f, w in zip(fused, want):
        assert torch.equal(f, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lights", [64, 65, 200])
def test_shade_kernel_light_tiles(dev, n_lights):
    """K2 with a full light tile, one light past it and 200 lights (the
    lights restaged tile by tile, the sum in the lights' order) on the
    configs-3/4 layout and the generic instantiation: against its plain
    version and bit-equal between the two instantiations."""
    mats, u, v, mat, shape, _ = _k2_binding(dev, "block_quad")
    p = _planes(dev, 19, shape)
    valid = p(0, 1) > 0.3
    args = (mats, u, v, (p(-5, 5), p(-5, 5), p(-5, 5)),
            (p(-1, 1), p(-1, 1), p(-1, 1)), (p(-1, 1), p(-1, 1), p(-1, 1)),
            valid, _odd_lights(dev, n_lights),
            torch.tensor([0.0, 1.0, -3.0], device=dev),
            torch.tensor(1, device=dev))
    kw = dict(vis_plane=p(0, 1), vis_light=n_lights - 1)
    got = shade_sampled(*args, **kw)
    want = shade_sampled_plain(*args, **kw)
    generic = shade_sampled(*args, generic=True, **kw)
    torch.cuda.synchronize()
    _assert_close_rel(got, want)
    for g, x in zip(got, generic):
        assert torch.equal(g, x)
        assert bool((g[~valid] == 0).all())
