"""The port's CUDA kernels vs their plain PyTorch versions on the GPU.

Every test here but the input-validation one needs an NVIDIA GPU and nvcc
(marker ``cuda``) and skips without one. The file imports no JAX, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py
"""

import dataclasses

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
    # The pair-rate warp mapping needs tile rows of a multiple of 16.
    block = _block_table("cpu", 3, 0)
    uv = torch.zeros((2, 1024))
    for pair in (1, 2):
        with pytest.raises(ValueError, match="multiple of 16"):
            tq.sample_table_block_kernel(block, uv, uv, pair_rows=pair,
                                         tile_w=8)


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
    calls, tails = [], []

    def capture(*a, **k):
        calls.append((a, k))
        return fused.raster_tiles(*a, **k)

    out = render_frame(scene.scene_data(), vb, fp, mats, None, s,
                       kernels=KERNELS._replace(raster=capture,
                                                raster_tail=_capture_tail(
                                                    tails)))
    ref = render_frame(scene.scene_data(), vb, fp, mats, None, s,
                       kernels=PLAIN)
    torch.cuda.synchronize()
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    assert torch.equal(out["image"], ref["image"])
    # Pass 0, then passes 1-7 as one tail launch.
    assert len(calls) == 1 and len(tails) == 1
    idf = fused._OUT_FIELDS.index("idf")
    for a, k in calls:
        want = fused.raster_tiles_plain(*a, **k)
        for c in fused.CLUSTER_SIZES:
            zk, f = fused.raster_tiles(*a, **k, cluster=c)
            torch.cuda.synchronize()
            assert torch.equal(zk, want[0]) and torch.equal(f[idf],
                                                            want[1][idf])
            assert float((f - want[1]).abs().max()) <= 1e-3
    _assert_tail_bit_equal(*tails[0])


def _capture_tail(calls: list):
    """A K1 tail that keeps each call's arguments, its planes cloned
    before the call writes them in place."""
    def run(*a, **k):
        calls.append((_clone_tail_args(a), k))
        return fused.raster_tiles_tail(*a, **k)
    return run


def _clone_tail_args(a):
    return a[:5] + (a[5].clone(), a[6].clone()) + a[7:]


def _assert_tail_bit_equal(a, k, repeats: int = 1):
    """The tail on the captured inputs equals its plain version (keys and
    the id plane bit for bit, the other planes within K1's 1e-3), and
    ``repeats`` launches give the same bits each."""
    want = fused.raster_tiles_tail_plain(*_clone_tail_args(a), **k)
    out_fields = a[10] if len(a) > 10 else k.get("out_fields",
                                                 fused._OUT_FIELDS)
    idf = out_fields.index("idf")
    first = None
    for _ in range(repeats):
        got = fused.raster_tiles_tail(*_clone_tail_args(a), **k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1][idf], want[1][idf])
        assert float((got[1] - want[1]).abs().max()) <= 1e-3
        if first is None:
            first = tuple(t.clone() for t in got)
        else:
            assert torch.equal(got[0], first[0])
            assert torch.equal(got[1], first[1])


@pytest.mark.cuda
def test_raster_tail_config4_views_bit_equal(dev):
    """K1's tail on config 4's three autotuned 1920×1080 views (64 balls,
    the default raster mode): each frame launches K1 twice, pass 0 and
    the tail; the tail equals its plain version on the same inputs, with
    live slots and slots whose tail is empty, five repeated launches (its
    atomic merge) give the same bits, and the frame equals the all-plain
    render."""
    import chip_smoke

    frames, fp, mats = chip_smoke.c4_frames(dev, modes=(("default", {}),))
    empty = live = 0
    for label, data, vb, s in frames:
        assert s.raster_passes > 1, label
        tails = []
        before = fused.raster_tiles.launches, fused.raster_tiles_tail.launches
        out = render_frame(data, vb, fp, mats, None, s,
                           kernels=KERNELS._replace(
                               raster_tail=_capture_tail(tails)))
        torch.cuda.synchronize()
        assert fused.raster_tiles.launches - before[0] == 2, label
        assert fused.raster_tiles_tail.launches - before[1] == 1, label
        assert all(int(d) == 0 for d in out["bin_diag"]), label
        ref = render_frame(data, vb, fp, mats, None, s, kernels=PLAIN)
        assert torch.equal(out["image"], ref["image"]), label
        (a, k), = tails
        counts = a[4]
        empty += int((counts == 0).sum())
        live += int((counts > 0).sum())
        _assert_tail_bit_equal(a, k, repeats=5)
    assert empty > 0 and live > 0


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
        raster_tail=fused.raster_tiles_tail_plain,
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
@pytest.mark.parametrize("pair", [1, 2], ids=["pairs", "quads"])
@pytest.mark.parametrize("generic", [False, True],
                         ids=["layout", "generic"])
def test_shade_kernel_pair_matches_plain(dev, frame, pair, generic):
    """K2 at a pair level (the block table read once a 2×1 / 2×2 group)
    against its plain version, with NaN planes at the misses (K2 reads a
    member's uv only where it is covered); the generic instantiation gives
    the layout's bits; level 0 still gives its own."""
    _, _, _, mats = frame
    lights = shaderball_lights(dev)
    p = _planes(dev, 11)
    valid = p(0, 1) > 0.3
    nan = torch.full_like(valid, float("nan"), dtype=torch.float32)
    u, v = (torch.where(valid, p(-2, 3), nan) for _ in range(2))
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    tangent = (p(-1, 1), p(-1, 1), p(-1, 1))
    args = (mats, u, v, world, normal, tangent, valid, lights,
            torch.tensor([0.0, 1.0, -3.0], device=dev),
            torch.tensor(1, device=dev))
    before = shade_sampled.pair_launches
    got = shade_sampled(*args, pair=pair, generic=generic)
    want = shade_sampled_plain(*args, pair=pair)
    torch.cuda.synchronize()
    assert shade_sampled.pair_launches == before + 1
    _assert_close_rel(got, want)
    fixed = shade_sampled(*args, pair=pair)
    assert all(torch.equal(a, b) for a, b in zip(got, fixed))
    level0 = shade_sampled(*args)
    assert not torch.equal(level0[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [1, 2], ids=["pairs", "quads"])
def test_sample_block_kernel_pair_bit_equal(dev, frame, pair):
    """K6 at a pair level equals its plain version, with a coverage plane
    (dead groups anchor at the min over all members) and without."""
    _, _, _, mats = frame
    block = next(t for t in mats if isinstance(t, tq.BlockTable))
    p = _planes(dev, 13, (12, 1024))
    u, v = p(-2, 3), p(-2, 3)
    valid = p(0, 1) > 0.5
    valid.view(12, 8, 128)[:, 2:4, 10:60] = False
    for val in (valid, None):
        before = tq.sample_table_block_kernel.pair_launches
        got = tq.sample_table_block_kernel(block, u, v, pair_rows=pair,
                                           valid=val)
        want = tq.sample_table_block(block, u, v, pair_rows=pair, valid=val)
        torch.cuda.synchronize()
        assert tq.sample_table_block_kernel.pair_launches == before + 1
        for slot in want:
            assert torch.equal(got[slot], want[slot]), slot


def _block_table(dev, n_slots: int, seed: int) -> tq.BlockTable:
    """A 64² block table of the first ``n_slots`` slots (channel stride
    4, 8 or 12 for 3, 6 or 10 slots)."""
    rng = np.random.default_rng(seed)
    maps = {s: rng.integers(0, 256, (64, 64, 1), dtype=np.uint8)
            for s in tq.SLOTS[:n_slots]}
    (table,) = tq.build_quad_tables(maps, block_threshold=1024, device=dev)
    assert isinstance(table, tq.BlockTable)
    return table


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [0, 1, 2], ids=["pixels", "pairs", "quads"])
@pytest.mark.parametrize("n_slots", [3, 6, 10],
                         ids=["cpad4", "cpad8", "cpad12"])
def test_sample_block_kernel_bit_equal_every_stride(dev, pair, n_slots):
    """K6 at each pair level and channel stride equals its plain version
    bit for bit, with NaN uv at the misses; at level 0 also on pixel
    counts that are not a multiple of its 4-pixel vectors (the scalar
    tail, the planes' padded stride)."""
    table = _block_table(dev, n_slots, 17 + n_slots)
    shapes = [(12, 1024)] + ([(4093,), (3, 7)] if pair == 0 else [])
    for shape in shapes:
        p = _planes(dev, 19, shape)
        valid = p(0, 1) > 0.3
        valid.view(-1)[:64] = False  # whole groups of misses
        nan = torch.full(shape, float("nan"), device=dev)
        u, v = (torch.where(valid, p(-2, 3), nan) for _ in range(2))
        kw = dict(pair_rows=pair, valid=valid) if pair else {}
        got = tq.sample_table_block_kernel(table, u, v, **kw)
        want = tq.sample_table_block(table, u, v, **kw)
        torch.cuda.synchronize()
        assert set(got) == set(want) == set(table.present)
        for slot in want:
            assert got[slot].shape == want[slot].shape == shape
            torch.testing.assert_close(got[slot], want[slot], rtol=0,
                                       atol=0, equal_nan=True)


@pytest.mark.cuda
def test_pair_kernels_need_tile_w_multiple_of_16(dev, frame):
    """K2 and K6 refuse a pair level on tile rows that are not a multiple
    of 16 (their warp mapping); no other path takes the call."""
    _, _, _, mats = frame
    block = next(t for t in mats if isinstance(t, tq.BlockTable))
    p = _planes(dev, 3)
    u, v = p(0, 1), p(0, 1)
    valid = p(0, 1) > 0.3
    planes = tuple(p(-1, 1) for _ in range(3))
    before = (tq.sample_table_block_kernel.launches, shade_sampled.launches)
    for pair in (1, 2):
        with pytest.raises(ValueError, match="multiple of 16"):
            tq.sample_table_block_kernel(block, u, v, pair_rows=pair,
                                         valid=valid, tile_w=8)
        with pytest.raises(ValueError, match="multiple of 16"):
            shade_sampled(mats, u, v, planes, planes, planes, valid,
                          shaderball_lights(dev),
                          torch.zeros(3, device=dev),
                          torch.tensor(1, device=dev), pair=pair, tile_w=8)
    assert (tq.sample_table_block_kernel.launches,
            shade_sampled.launches) == before


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


def _mixed_mip_table(dev):
    """One MipBlockMulti of two materials with different level counts: a
    seeded 256² albedo pyramid (its last parent stored) and a 128² one cut
    at 3 levels (a true last level)."""
    rng = np.random.default_rng(5)
    mats = []
    for n, max_levels in ((256, None), (128, 3)):
        mips = tq.build_mip_pyramid(
            rng.integers(0, 256, (n, n, 3), dtype=np.uint8), max_levels)
        mats.append(tq.build_mip_block_tables(
            {s: [m[:, :, k:k + 1] for m in mips]
             for k, s in enumerate(("alb_r", "alb_g", "alb_b"))},
            device=dev))
    table, = tq.merge_mip_block_materials(tuple(mats))
    assert table.last_parent == (True, False)
    return table


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edges", "rho_stress", "no_ids"])
def test_mip_block_kernel_edges_bit_equal(dev, case):
    """K8, now computing its LOD and footprint itself, on negative uv and
    uv past 1, ids out of range both ways, materials with different level
    counts and a true last level, no id plane, and LODs on powers of two
    and 1-4 float steps beside them (``chip_smoke.mip_rho_stress``): every
    slot plane ``torch.equal`` to its plain version."""
    import chip_smoke

    table = _mixed_mip_table(dev)
    if case == "rho_stress":
        mat, u, v = chip_smoke.mip_rho_stress(table, 96, dev)
    else:
        u, v, mat = _smooth_uv(dev, 7, nt=48)
        gen = np.random.default_rng(7)
        mat = (None if case == "no_ids" else torch.as_tensor(
            gen.integers(-2, 4, u.shape).astype(np.int32), device=dev))
    before = tq.sample_mip_block_kernel.launches
    got = tq.sample_mip_block_kernel(table, mat, u, v)
    want = tq.sample_mip_block(table, mat, u, v)
    torch.cuda.synchronize()
    assert tq.sample_mip_block_kernel.launches == before + 1
    for slot in want:
        assert torch.equal(got[slot], want[slot]), slot
    g = tq._mip_block_geometry(table, mat, u, v, 8, 128)
    assert len(g["l0"].unique()) >= 4
    if case == "rho_stress":
        assert bool((g["frac"] == 0).any()) and bool((g["frac"] > 0).any())


@pytest.mark.cuda
def test_mip_block_kernel_one_launch(dev):
    """On CUDA tensors K8's wrapper puts one kernel on the card and no
    torch geometry op (after the binding's level table is made)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    table = _mixed_mip_table(dev)
    u, v, mat = _smooth_uv(dev, 8)
    tq.sample_mip_block_kernel(table, mat, u, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tq.sample_mip_block_kernel(table, mat, u, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "mip_block_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("gcap", [64, 4096], ids=["drops", "no_drops"])
@pytest.mark.parametrize("init", ["frame", "ties"])
def test_group_window_kernel_every_split(dev, frame, gcap, init):
    """K10 at every cluster size on the frame's group-window call, whose
    slots rescan prefix rows (bases 8-aligned below their first row) and,
    with a 64-row window, lose dropped rows: bit-equal to its plain
    version. "ties": the initial keys are the call's own result."""
    rec, setup = _setup(frame)
    kw = dict(max_candidates=512, overflow_cap=64, span_cap=16,
              raster_tile_cap=96)
    k1, gw = [], []

    def capture(store, fn):
        def run(*a, **k):
            store.append((list(a), k))
            return fn(*a, **k)
        return run

    fused.raster_fused(rec, setup, W, H, raster=capture(k1,
                                                        fused.raster_tiles),
                       **kw)
    out = fused.raster_fused(rec, setup, W, H, group_pair_cap=gcap,
                             raster_gw=capture(gw, fused.raster_tiles_gw),
                             **kw)
    (a, k), = gw
    lb = torch.clamp(k1[0][0][5] - a[5].repeat_interleave(a[9]), 0, gcap)
    assert torch.equal(lb - lb % 8, a[6]) and bool((lb % 8 > 0).any())
    assert (int(out[2].dropped_cap) > 0) == (gcap == 64)
    if init == "ties":
        a[8] = fused.raster_tiles_gw_plain(*a, **k)[0]
    want = fused.raster_tiles_gw_plain(*a, **k)
    for c in fused.CLUSTER_SIZES:
        got = fused.raster_tiles_gw(*a, **k, cluster=c)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (init, c)


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


def _capture_overlay(calls):
    """An overlay entry point that records K4's arguments (its LDR input
    as it was) and runs the kernel."""
    def run(*args, **kw):
        calls.append((args[:9] + (args[9].clone(),) + args[10:], kw))
        return fused.overlay_tiles(*args, **kw)
    return run


def _assert_overlay_in_place(args, kw, buf, view):
    """K4 at every cluster size and cluster count (the fixed grid, one
    cluster, and one per slot as a grid sized from the list) composites
    into ``view`` — the first NT tiles of ``buf`` — in place: equal to the
    plain version, only the live tiles' pixels written, the pad tile and
    an alias of the same storage unchanged elsewhere."""
    want = fused.overlay_tiles_plain(*args, **kw)
    k = int(args[4].shape[0])
    n_live = int(args[7][0])
    live = torch.zeros(view.shape[1], dtype=torch.bool, device=view.device)
    live[args[4][:n_live].long()] = True
    for c in fused.CLUSTER_SIZES:
        for clusters in (None, 1, k):
            buf.copy_(torch.cat([args[9], buf[:, -1:]], dim=1))
            pad = buf[:, -1].clone()
            alias = buf[1]  # another view of the same storage
            got = fused.overlay_tiles(*args[:9], view, *args[10:], **kw,
                                      cluster=c, clusters=clusters)
            torch.cuda.synchronize()
            assert got is view
            assert torch.equal(view, want), (c, clusters)
            assert torch.equal(buf[:, -1], pad)
            assert torch.equal(alias[:-1], want[1])
            changed = (view != args[9]).any(dim=0).any(dim=1)
            assert not bool((changed & ~live).any())
    return want


@pytest.mark.cuda
def test_overlay_kernel_bit_equal(dev, frame):
    """The light spheres over the test frame's keys (K4 against its plain
    version, in place, at every launch shape)."""
    scene, vb, _, _ = frame
    rec, setup = _setup(frame)
    _, zkey, _ = fused.raster_fused(rec, setup, W, H, max_candidates=512)
    overlay = make_overlay_resources(dev, with_gizmo=False)
    lights = scene.lights._replace(pos=torch.tensor(
        [[0.3, 0.1, 2.2], [-0.4, -0.2, 3.1], [1.0, 0.3, 4.5]], device=dev))
    vp = m3.matmul(vb.proj, vb.view)
    s = RenderSettings(width=W, height=H)
    nt = s.tiles_x * s.tiles_y
    buf = torch.rand((3, nt + 1, 1024), device=dev)
    before = buf.clone()
    calls = []
    got, diag = _composite_light_spheres(
        buf[:, :nt], zkey, lights, overlay, vp, s,
        KERNELS._replace(overlay=_capture_overlay(calls)))
    want, _ = _composite_light_spheres(before[:, :nt], zkey, lights,
                                       overlay, vp, s, PLAIN)
    torch.cuda.synchronize()
    assert int(diag.dropped_tiles) == 0
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got, want)
    assert bool((want != before[:, :nt]).any())
    assert torch.equal(buf[:, nt], before[:, nt])
    assert _light_sphere_planar_soup(lights, overlay, vp).num_triangles > 0
    args, kw = calls[0]
    assert kw["max_count"] == 384 + 512
    _assert_overlay_in_place(args, kw, buf, buf[:, :nt])


@pytest.mark.cuda
@pytest.mark.parametrize("text", [
    " 60.0 FPS  POS 0.0 1.0 3.0  YAW -90 PITCH 0",
    "8888888888MMMMMMMMMMWWWWWWWWWW%%%%%%%%%%"], ids=["stats", "dense"])
def test_overlay_kernel_hud_bit_equal(dev, frame, text):
    """The HUD (a line at the frame's scale 2: up to ~440 candidates a tile
    against a cleared key) through K4: the frame's composite against the
    plain version, in place, at every launch shape."""
    from bibim_tpu_torch.host.hud import build_hud_geometry, hud_text_mask
    from bibim_tpu_torch.pipeline.framegraph import _composite_hud

    s = RenderSettings(width=W, height=H)
    nt = s.tiles_x * s.tiles_y
    geom = build_hud_geometry(W, H, max_chars=40, origin=(1, 1))
    hud = (geom, hud_text_mask(text, geom.max_chars))
    buf = torch.rand((3, nt + 1, 1024), device=dev)
    before = buf.clone()
    calls = []
    got, diag = _composite_hud(buf[:, :nt], hud, s, KERNELS._replace(
        overlay=_capture_overlay(calls)))
    want, _ = _composite_hud(before[:, :nt], hud, s, PLAIN)
    torch.cuda.synchronize()
    assert all(int(d) == 0 for d in diag)
    assert torch.equal(got, want)
    args, kw = calls[0]
    assert args[8] is None  # a cleared key, no key plane
    # Long windows: the split engages (dense: the capacity's range).
    assert int(args[6].max()) > (200 if text[0] == "8" else 100)
    _assert_overlay_in_place(args, kw, buf, buf[:, :nt])


@pytest.mark.cuda
@pytest.mark.parametrize("stretch", [
    dict(),
    dict(enable_shadows=True, shadow_fit_batches=(0,), shadow_size=512,
         shadow_tile_cap=256, shadow_query_tile_cap=120),
    dict(enable_ibl=True),
    dict(enable_shadows=True, shadow_fit_batches=(0,), enable_ibl=True),
    dict(pair_sampling=2, pair_lossy=True),
    dict(pair_sampling=2, pair_lossy=True, enable_ibl=True),
    dict(enable_shadows=True, shadow_fit_batches=(0,),
         pair_visibility=True),
], ids=["deferred", "shadows", "ibl", "shadows_ibl", "lossy", "lossy_ibl",
        "pair_visibility"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [1, 2], ids=["pairs", "quads"])
def test_routed_frame_equals_exact_frame(dev, frame, pair):
    """The routed frame (a K2 pass at the pair level on the clean tiles,
    one per pixel on the rest) equals the pair-0 frame bit for bit."""
    scene, vb, fp, mats = frame
    s = RenderSettings(width=W, height=H, outputs="image+diag",
                       show_gizmo=False, show_lights=False,
                       max_candidates=256, live_tile_cap=120,
                       raster_tile_cap=128, span_mid_cap=1024)
    routed = dataclasses.replace(s, pair_sampling=pair,
                                 sample_route_caps=(120, 120))
    before = shade_sampled.pair_launches
    out = render_frame(scene, vb, fp, mats, None, routed)
    ref = render_frame(scene, vb, fp, mats, None, s)
    torch.cuda.synchronize()
    assert shade_sampled.pair_launches == before + 1
    assert int(out["bin_diag"].dropped_tiles) == 0
    assert torch.equal(out["image"], ref["image"])


_VARIANT_FN = {"earlyz": "raster_tiles_earlyz", "group_pair_cap":
               "raster_tiles_gw", "fine_bins": "raster_tiles_fine"}
_PLAIN_RASTERS = dict(raster=fused.raster_tiles_plain,
                      raster_earlyz=fused.raster_tiles_earlyz_plain,
                      raster_gw=fused.raster_tiles_gw_plain,
                      raster_fine=fused.raster_tiles_fine_plain,
                      raster_tail=fused.raster_tiles_tail_plain,
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


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(earlyz=True, max_candidates=512),
    dict(earlyz=True, max_candidates=48, passes=4, raster_tile_cap=96,
         dense_tile_cap=64),
    dict(fine_bins=True, max_candidates=512),
], ids=["earlyz", "earlyz_multipass", "fine_bins"])
@pytest.mark.parametrize("init", ["frame", "ties"])
def test_raster_variant_kernels_every_split(dev, frame, kw, init):
    """K9 at every cluster size and K11 at every warp split, on each
    captured call of the frame: bit-equal to their plain versions. "ties":
    the initial keys (and K9's draw orders) are the call's own result, so
    every covered pixel's winner ties them."""
    rec, setup = _setup(frame)
    name = "raster_earlyz" if "earlyz" in kw else "raster_fine"
    kern = getattr(fused, _VARIANT_FN["earlyz" if "earlyz" in kw
                                       else "fine_bins"])
    plain = getattr(fused, f"{kern.__name__}_plain")
    calls = []

    def capture(*a, **k):
        calls.append((list(a), k))
        return kern(*a, **k)

    fused.raster_fused(rec, setup, W, H, overflow_cap=64, span_cap=16,
                       **{name: capture}, **kw)
    zi = 7 if name == "raster_earlyz" else 8  # init_zkey's position
    for a, k in calls:
        if init == "ties":
            out = plain(*a, **k)
            a[zi] = out[0]
            if name == "raster_earlyz":
                a[zi + 1] = out[1]
        want = plain(*a, **k)
        splits = (fused.CLUSTER_SIZES if name == "raster_earlyz"
                  else fused.FINE_PARTS)
        for c in splits:
            knob = {"cluster" if name == "raster_earlyz" else "parts": c}
            got = kern(*a, **k, **knob)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (init, c)


def _occluded_layers(dev, layers=40, cell=16):
    """Clip-space test geometry for K9's break: two near triangles (z 0.9,
    spanning the viewport: the overflow list) in front of ``layers`` grids
    of small far triangles (z 0.4 down in steps of 0.01), one per 16-px
    cell and layer: windows of 8 · ``layers`` candidates, longer than one
    of K9's rounds."""
    tris = [[[-3.0, -3.0, 0.9, 1.0], [3.0, -3.0, 0.9, 1.0],
             [0.0, 5.0, 0.9, 1.0]]] * 2
    for layer in range(layers):
        z = 0.4 - 0.01 * layer
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
    every window candidate is farther, so a tile scanned by one block stops
    after its first window round; the chunk counter shows the skip, and
    zkey, okey and every plane equal the plain version's (which scans
    everything) and K1's frame. At every cluster size the outputs stay
    equal; a split slot's later parts do not hold the occluder's keys, so
    they scan on. A second pass from the first pass's keys gives every
    part the occluder's keys as its bound: a later part stops after its
    first round too, while the next round's copies are bound for the
    bytes its merge reuses; the outputs stay equal, and at cluster 2 the
    counter shows the later part's skip."""
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
    want = fused.raster_tiles_earlyz_plain(*a, **k)
    a2 = (*a[:7], want[0], want[1], *a[9:])
    want2 = fused.raster_tiles_earlyz_plain(*a2, **k)
    scanned = {}
    for again, args, ref in ((False, a, want), (True, a2, want2)):
        for c in fused.CLUSTER_SIZES:
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            out = fused.raster_tiles_earlyz(*args, **k, cluster=c,
                                            stats=stats)
            torch.cuda.synchronize()
            for x, y in zip(out, ref):
                assert torch.equal(x, y), (again, c)
            scanned[again, c], present = stats.tolist()
            assert 0 < scanned[again, c] <= (
                present // 2 if c == 1 else present), (again, c, present)
    assert scanned[True, 2] < scanned[False, 2], scanned
    _assert_rasters_equal(got, base)
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


@pytest.mark.cuda
def test_forward_shade_kernels_match_plain(dev, frame):
    """The forward frame's shading calls: K2 at ``quantize=False`` (raw
    samples, no G-buffer fp16) with and without the fused fp16 + tone-map
    tail, NaN in every plane at the misses; K5 at ``quantize=False`` /
    ``tonemap=False`` on unquantized planes with the IBL ambient and a
    visibility plane — each against its plain version, one launch a
    call."""
    _, _, _, mats = frame
    lights = shaderball_lights(dev)
    p = _planes(dev, 23)
    valid = p(0, 1) > 0.3
    nan = torch.full_like(valid, float("nan"), dtype=torch.float32)

    def dirty(x):
        return torch.where(valid, x, nan)

    args = (mats, dirty(p(-2, 3)), dirty(p(-2, 3)),
            tuple(dirty(p(-5, 5)) for _ in range(3)),
            tuple(dirty(p(-1, 1)) for _ in range(3)),
            tuple(dirty(p(-1, 1)) for _ in range(3)), valid, lights,
            torch.tensor([0.0, 1.0, -3.0], device=dev),
            torch.tensor(1, device=dev))
    tail = dict(quantize_hdr=True, tonemap=True,
                enable_tone_mapping=torch.tensor(1, device=dev),
                exposure=torch.tensor(1.0, device=dev))
    for kw in (dict(quantize=False), dict(quantize=False, **tail)):
        before = shade_sampled.launches
        got = shade_sampled(*args, **kw)
        want = shade_sampled_plain(*args, **kw)
        torch.cuda.synchronize()
        assert shade_sampled.launches == before + 1
        _assert_close_rel(got, want)
        for g in got:
            assert bool((g[~valid] == 0).all())
    q = _planes(dev, 29)
    gargs = ((q(-5, 5), q(-5, 5), q(-5, 5)), (q(-1, 1), q(-1, 1), q(-1, 1)),
             (q(0, 1), q(0, 1), q(0, 1)), q(0, 1), q(0.05, 1), q(0, 1),
             valid, lights, torch.tensor([0.0, 1.0, -3.0], device=dev),
             torch.tensor(1, device=dev), torch.tensor(1.0, device=dev))
    opts = dict(quantize=False, tonemap=False, vis_plane=q(0, 1),
                vis_light=0, ambient=(q(0, 0.2), q(0, 0.2), q(0, 0.2)))
    before = shade_tonemap.launches
    got = shade_tonemap(*gargs, **opts)
    want = shade_tonemap_plain(*gargs, **opts)
    torch.cuda.synchronize()
    assert shade_tonemap.launches == before + 1
    _assert_close_rel(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("binding", ["tables", "mip_block"])
def test_two_tap_sample_kernels_bit_equal(dev, frame, binding):
    """One 2-tap anisotropic sample (``framegraph._sample_materials``):
    through KERNELS each table's sampler launches twice — K6 and K7 on the
    block + quad tables, K8 and K7 on the merged mip groups — and the
    averaged slot planes equal the all-plain sample bit for bit."""
    from bibim_tpu_torch.ops.fused import FusedPixels
    from bibim_tpu_torch.pipeline import framegraph as fg

    if binding == "tables":
        mats = frame[3]
        p = _planes(dev, 31, (12, 1024))
        u, v = p(-2, 3), p(-2, 3)
        mat = torch.zeros_like(u, dtype=torch.int32)
        fns = (tq.sample_table_block_kernel, tq.sample_rows_small)
    else:
        mats = _cube_tables(dev, None)
        u, v, mat = _smooth_uv(dev, 5)
        fns = (tq.sample_mip_block_kernel, tq.sample_rows_small)
    zero = torch.zeros_like(u)
    tri = torch.zeros_like(mat)
    px = FusedPixels(tri_id=tri, depth=zero, bary=(zero,) * 3, uv=(u, v),
                     normal=(zero,) * 3, tangent=(zero,) * 3,
                     world=(zero,) * 3, color=(zero,) * 3, mat_id=mat)
    s = RenderSettings(aniso_taps=2)
    before = [f.launches for f in fns]
    got = fg._sample_materials(mats, px, s, KERNELS)
    assert [f.launches for f in fns] == [b + 2 for b in before]
    want = fg._sample_materials(mats, px, s, PLAIN)
    one = fg._sample_materials(mats, px, RenderSettings(), PLAIN)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for slot in want:
        assert torch.equal(got[slot], want[slot]), slot
    assert any(not torch.equal(want[k], one[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(deferred=False),
    dict(deferred=False, enable_shadows=True, shadow_fit_batches=(0,),
         enable_ibl=True),
    dict(aniso_taps=2),
    dict(geometry="legacy", enable_shadows=True, shadow_fit_batches=(0,)),
    dict(show_tbn=True),
], ids=["forward", "forward_shadows_ibl", "aniso2", "legacy_shadows", "tbn"])
def test_new_path_frames_vs_plain(dev, frame, kw):
    """Forward, anisotropic, (T, 3) and TBN frames on the card: their
    kernels launch (K2 on the forward frame; K6 / K7 twice and K5 at two
    taps or with IBL; K1 on the (T, 3) main and shadow passes) and the
    frame stays within the golden bound of its all-plain render."""
    from bibim_tpu_torch.ops.ibl import make_ibl_sh

    scene, vb, fp, mats = frame
    overlay = make_overlay_resources(dev, with_gizmo=False)
    s = RenderSettings(width=W, height=H, outputs="image+diag",
                       show_gizmo=False, max_candidates=256,
                       live_tile_cap=120, raster_tile_cap=128,
                       span_mid_cap=1024, **kw)
    ibl = make_ibl_sh(device=dev)
    samples = s.enable_ibl or s.aniso_taps > 1
    fns = [fused.raster_tiles, sort.sort_keys, fused.overlay_tiles]
    fns += ([shade_tonemap, tq.sample_table_block_kernel,
             tq.sample_rows_small] if samples else [shade_sampled])
    counts = [f.launches for f in fns]
    out = render_frame(scene, vb, fp, mats, overlay, s, ibl=ibl)
    ref = render_frame(scene, vb, fp, mats, overlay, s, ibl=ibl,
                       kernels=PLAIN)
    torch.cuda.synchronize()
    after = [f.launches for f in fns]
    assert all(a > b for a, b in zip(after, counts))
    if s.aniso_taps > 1:
        assert after[4] - counts[4] == 2 and after[5] - counts[5] == 2
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    d = (out["image"].int() - ref["image"].int()).abs()
    assert int(d.max()) <= 2
    assert float((d > 0).any(dim=-1).float().mean()) <= 1e-3


@pytest.mark.cuda
def test_session_frame_equals_direct_render(dev, tmp_path):
    """A 1280×720 ShaderBall frame of the interactive Session on the card
    (on chip_smoke's stand-in resource root, readback depth 2: the frame
    comes back one render later) equals render_frame at the session's
    pose and settings, and went through K1-K4."""
    import chip_smoke
    from bibim_tpu_torch.assets import asset_cache
    from bibim_tpu_torch.host.gui import UiState
    from bibim_tpu_torch.host.session import Session
    from bibim_tpu_torch.ops.sort import sort_keys
    from bibim_tpu_torch.utils import config

    old = config._active_root, asset_cache.CACHE_DIR
    config.init_resource_root(chip_smoke.write_standin_resources(
        tmp_path / "res", map_size=256, cube_sizes=(64, 64)))
    asset_cache.CACHE_DIR = tmp_path / "cache"
    try:
        s = Session(width=1280, height=720, ui=UiState(
            scene="shaderball", enable_tone_mapping=True))
        fns = [fused.raster_tiles, shade_sampled, sort_keys,
               fused.overlay_tiles]
        counts = [f.launches for f in fns]
        s.handle_event({"mouse": True, "cursor": [0, 0]})
        s.handle_event({"cursor": [20, 6]})
        assert s.render(1 / 60) is None
        cam, settings = s.camera, s.settings()
        vb = ViewBlock(
            view=torch.as_tensor(cam.get_view_matrix(), device=dev),
            proj=m3.perspective(60.0, 1280 / 720, 0.1, 1000.0,
                                device="cpu").to(dev),
            view_pos=torch.as_tensor(cam.pos, device=dev),
            enable_normal_map=torch.tensor(0, dtype=torch.int32, device=dev))
        fp = FrameParams(
            enable_tone_mapping=torch.tensor(1, dtype=torch.int32,
                                             device=dev),
            exposure=torch.tensor(1.0, dtype=torch.float32, device=dev))
        want = render_frame(s.scene.scene_data(), vb, fp, s.materials(),
                            s.overlay(), settings)["image"].cpu()
        got = s.render(1 / 60)
        assert got is not None and got.shape == (720, 1280, 3)
        assert torch.equal(torch.from_numpy(got), want)
        assert all(f.launches > c for f, c in zip(fns, counts))
        assert len(s.flush()) == 1
    finally:
        config._active_root, asset_cache.CACHE_DIR = old


@pytest.mark.cuda
def test_sharded_frame_matches_plain_kernels(frame, dev):
    """The 512×256 frame with light spheres and shadows on 4 bands on the
    card(s): through the kernels (K1, K2, K3, K4 launched on every band)
    within the golden bound of its twin through the plain versions, and of
    the single-card frame; drop-free."""
    from bibim_tpu_torch.parallel import (
        make_device_mesh,
        render_frame_sharded,
    )
    from bibim_tpu_torch.ops.sort import sort_keys

    scene, vb, fp, mats = frame
    overlay = make_overlay_resources(device=dev, with_gizmo=False)
    s = RenderSettings(width=W, height=H, show_gizmo=False,
                       enable_shadows=True, shadow_size=512,
                       shadow_fit_batches=(0,), max_candidates=512,
                       outputs="image")
    mesh = make_device_mesh(4)
    fns = [fused.raster_tiles, shade_sampled, sort_keys,
           fused.overlay_tiles]
    counts = [f.launches for f in fns]
    got, diag = render_frame_sharded(mesh, scene, vb, fp, mats, s,
                                     overlay=overlay, return_diag=True)
    # K1: a main pass a band and a shadow pass a card; K2 once a band.
    assert [f.launches - c for f, c in zip(fns, counts)][:2] == [
        4 + len(set(mesh.devices)), 4]
    assert all(f.launches - c >= 4 for f, c in zip(fns[2:], counts[2:]))
    assert not any(int(v) for v in diag)
    plain = render_frame_sharded(mesh, scene, vb, fp, mats, s,
                                 overlay=overlay, kernels=PLAIN)
    single = render_frame(scene, vb, fp, mats, overlay, s)["image"]
    for want in (plain, single):
        d = (got.to(torch.int32) - want.to(torch.int32)).abs()
        assert int(d.max()) <= 2
        assert float((d > 0).any(dim=-1).float().mean()) <= 1e-3
