"""Shared inputs of the port's CPU tests (tests/test_torch_*.py): one small
scene built with the JAX package — a UV sphere in front of the camera over
the 100× ground plane, the ShaderBall lights — and seeded numpy material
maps, plus helpers that carry the JAX package's arrays into the port
(through numpy, as bibim_tpu_torch.interop does).

XLA on the CPU contracts ``a*b + c`` into fused multiply-adds inside its
fusions; the port, like the TPU kernels it replaces, rounds every product
and sum. Float arrays the two compute independently therefore agree to a
few ulps rather than bit for bit; integer results (triangle ids, depth
keys, binning) and arrays that are pure data movement agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

W, H = 256, 128
TILE_H, TILE_W = 8, 128
TX = W // TILE_W
NT = (H // TILE_H) * TX


def cap_threads() -> None:
    """Several test workers share the machine with JAX."""
    torch.set_num_threads(2)


def jax_scene():
    """(SceneData, view, proj) of the test scene, JAX package types."""
    import jax.numpy as jnp

    from bibim_tpu import math3d as m3
    from bibim_tpu.assets.meshgen import (
        generate_plane_mesh,
        generate_uv_sphere_mesh,
    )
    from bibim_tpu.scene.camera import FreeLookCamera
    from bibim_tpu.scene.scene import SceneData, batch_from_mesh
    from bibim_tpu.scene.shaderball import shaderball_lights

    sphere = generate_uv_sphere_mesh(1.0, 24, 16)
    model = np.asarray(m3.translate([0.0, -0.3, 3.0]))
    plane_model = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane_model[1, 3] = -1.5
    scene = SceneData(
        batches=(batch_from_mesh(sphere, model),
                 batch_from_mesh(generate_plane_mesh(), plane_model)),
        lights=shaderball_lights(),
    )
    view = jnp.asarray(FreeLookCamera().get_view_matrix())
    proj = m3.perspective(60.0, W / H, 0.1, 1000.0)
    return scene, view, proj


def material_maps(seed: int = 0) -> dict:
    """Seeded u8 maps: 64² metallic/roughness/ao (a block table at
    block_threshold=1024) and 16² albedo/normal/height (a quad table)."""
    rng = np.random.default_rng(seed)

    def m(n):
        return rng.integers(0, 256, (n, n, 1), dtype=np.uint8)

    maps = {s: m(64) for s in ("metallic", "roughness", "ao")}
    maps.update({s: m(16) for s in ("alb_r", "alb_g", "alb_b", "nrm_x",
                                   "nrm_y", "nrm_z", "height")})
    return maps


def t(x, dtype=None) -> torch.Tensor:
    out = torch.as_tensor(np.array(np.asarray(x), copy=True))
    return out if dtype is None else out.to(dtype)


def planar_setup(js):
    """The JAX package's PlanarSetup as the port's."""
    from bibim_tpu_torch.ops.raster import PlanarSetup

    def tup(x):
        return tuple(t(c) for c in x)

    return PlanarSetup(
        edge_a=tup(js.edge_a), edge_b=tup(js.edge_b), edge_c=tup(js.edge_c),
        z_coef=tup(js.z_coef), w_coef=tup(js.w_coef),
        bbox=tuple(t(c, torch.int32) for c in js.bbox),
        valid=t(js.valid, torch.bool),
        zub=None if js.zub is None else t(js.zub))


def record_table(jrec) -> torch.Tensor:
    """(T, 128) JAX records → the port's (T, 64) rows (60 used channels)."""
    from bibim_tpu_torch.ops.fused import REC_CH, _USED

    r = np.asarray(jrec)
    assert not r[:, _USED:].any()
    return t(r[:, :REC_CH]).contiguous()


def ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps between two float32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, (-(1 << 31)) - ia, ia)
    ib = np.where(ib < 0, (-(1 << 31)) - ib, ib)
    return np.abs(ia - ib)
