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

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops import fused, sort
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading import shade_sampled, shade_sampled_plain
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
from bibim_tpu_torch.ops.raster import triangle_setup_planar
from bibim_tpu_torch.scene.camera import FreeLookCamera
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


@pytest.mark.cuda
@pytest.mark.parametrize("deferred", [True, False])
def test_shade_kernel_matches_plain(dev, frame, deferred):
    _, _, _, mats = frame
    lights = shaderball_lights(dev)
    gen = torch.Generator().manual_seed(5)

    def p(lo, hi):
        return (lo + (hi - lo) * torch.rand((10, 1024), generator=gen)).to(
            dev)

    u, v = p(-2, 3), p(-2, 3)
    world = (p(-5, 5), p(-5, 5), p(-5, 5))
    normal = (p(-1, 1), p(-1, 1), p(-1, 1))
    tangent = (p(-1, 1), p(-1, 1), p(-1, 1))
    valid = p(0, 1) > 0.3
    for nm in (0, 1):
        args = (mats, u, v, world, normal, tangent, valid, lights,
                torch.tensor([0.0, 1.0, -3.0], device=dev),
                torch.tensor(nm, device=dev))
        got = shade_sampled(*args, gbuffer_mode=deferred, quantize=deferred)
        want = shade_sampled_plain(*args, gbuffer_mode=deferred,
                                   quantize=deferred)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            diff = ((g - w).abs() / (1.0 + w.abs())).cpu().numpy()
            assert (diff > 5e-5).mean() < 1e-3 and diff.max() < 2e-3


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
def test_frame_kernels_vs_plain(dev, frame):
    scene, vb, fp, mats = frame
    overlay = make_overlay_resources(dev, with_gizmo=False)
    s = RenderSettings(width=W, height=H, outputs="image+diag",
                       show_gizmo=False, max_candidates=256,
                       live_tile_cap=120, raster_tile_cap=128,
                       span_mid_cap=1024)
    counts = [f.launches for f in (fused.raster_tiles, shade_sampled,
                                   sort.sort_keys, fused.overlay_tiles)]
    out = render_frame(scene, vb, fp, mats, overlay, s)
    ref = render_frame(scene, vb, fp, mats, overlay, s, kernels=PLAIN)
    torch.cuda.synchronize()
    after = [f.launches for f in (fused.raster_tiles, shade_sampled,
                                  sort.sort_keys, fused.overlay_tiles)]
    assert all(a > b for a, b in zip(after, counts))
    for k in range(4):
        assert int(out["bin_diag"][k]) == 0
    d = (out["image"].int() - ref["image"].int()).abs()
    assert int(d.max()) <= 2
    assert float((d > 0).any(dim=-1).float().mean()) <= 1e-3
