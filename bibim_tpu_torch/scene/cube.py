"""CubeScene (port of ``bibim_tpu.scene.cube``) — BASELINE config 2:
two textured unit cubes side by side, one per material, under a
directional + point light pair, with trilinear mip-block albedos (or,
``with_mips=False``, level-0 ``MaterialTextures``).

Material 0's albedo is uv_debug.png and material 1's texture.jpg; the other
maps are 4×4 neutral constants. :func:`cube_material_tables` builds the
binding from any two albedo images (seeded stand-ins where the files are
absent, :func:`seeded_albedos`); :func:`cube_scene_materials` loads the
files from the resource root.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.scene.lights import LightType, make_lights
from bibim_tpu_torch.scene.meshgen import generate_cube_mesh
from bibim_tpu_torch.scene.scene import (
    DrawBatch,
    SceneBase,
    SceneData,
    batch_from_mesh,
)


def cube_model(tx: float, ty: float, tz: float,
               angle_y_deg: float) -> np.ndarray:
    a = np.radians(angle_y_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, -s, tx], [0, 1, 0, ty], [s, 0, c, tz],
                     [0, 0, 0, 1]], np.float32)


@dataclass
class CubeScene(SceneBase):
    """``spin`` turns cube A (only) 30° a second about y in
    :meth:`update_scene`; like the JAX package's CubeScene, it replaces
    cube A's model matrix and keeps its inverse."""

    spin: bool = False
    angle: float = 25.0
    device: str = "cuda"
    _cube_a: DrawBatch | None = field(default=None, repr=False)
    _cube_b: DrawBatch | None = field(default=None, repr=False)
    _lights: object = field(default=None, repr=False)

    def __post_init__(self):
        mesh = generate_cube_mesh(1.2)
        self._cube_a = batch_from_mesh(
            mesh, cube_model(-0.9, 0.0, 3.0, self.angle), device=self.device)
        self._cube_b = batch_from_mesh(
            mesh, cube_model(0.9, 0.0, 3.0, -self.angle), device=self.device)
        self._lights = make_lights([
            dict(type=LightType.DIRECTIONAL, dir=(-0.5, -1, 0.5),
                 color=(1, 1, 1), intensity=3.0),
            dict(type=LightType.POINT, pos=(0, 2, 1), color=(1, 1, 1),
                 intensity=8.0),
        ], device=self.device)

    def update_scene(self, dt: float) -> None:
        if self.spin:
            self.angle += 30.0 * dt
            self._cube_a = self._cube_a._replace(model=torch.as_tensor(
                cube_model(-0.9, 0, 3.0, self.angle)[None],
                device=self._cube_a.model.device))

    def scene_data(self) -> SceneData:
        return SceneData(batches=(self._cube_a, self._cube_b),
                         lights=self._lights)

    @property
    def material_ids(self) -> tuple:
        return (0, 1)


def seeded_albedos(seed: int = 0, sizes=(1024, 2048)) -> tuple:
    """Stand-ins for the two albedo images: seeded random RGBA u8 squares
    (powers of two, so every level down to 4×4 builds as block rows)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, n, 4), dtype=np.uint8)
                 for n in sizes)


def cube_material_tables(albedos, layout: str = "block", device="cuda",
                         with_mips: bool = True):
    """The cube binding from two (H, W, ≥3) u8 albedos (the 4×4 neutral
    maps for the rest). ``with_mips``: each albedo's mip pyramid
    (:func:`~bibim_tpu_torch.ops.texture_quad.build_mip_pyramid`) and the
    neutral maps per material, merged across the materials — mip block
    tables (``layout="block"``, the production binding: one MipBlockMulti
    for the albedos, one single-level MipQuadMulti for the neutral maps)
    or paired mip-quad tables (``"quad"``, the oracle form). Without:
    one ``MaterialTextures`` per material (level-0 bilinear, the
    reference sampler's parity), chosen per batch."""
    if layout == "block":
        build, merge = tq.build_mip_block_tables, tq.merge_mip_block_materials
    elif layout == "quad":
        build, merge = tq.build_mip_quad_tables, tq.merge_mip_quad_materials
    else:
        raise ValueError(f"layout={layout!r}")

    def neutral(rgba):
        return np.tile(np.asarray(rgba, np.uint8), (4, 4, 1))

    n_norm = neutral((128, 128, 255, 255))
    n_metal = neutral((0, 0, 0, 255))
    n_rough = neutral((180, 180, 180, 255))
    n_ao = neutral((255, 255, 255, 255))
    n_height = neutral((0, 0, 0, 255))
    if not with_mips:
        from bibim_tpu_torch.pipeline.framegraph import MaterialTextures

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return tuple(MaterialTextures(
            albedo=t(albedo), metallic=t(n_metal), roughness=t(n_rough),
            ao=t(n_ao), normal=t(n_norm), height=t(n_height))
            for albedo in albedos)
    mats = []
    for albedo in albedos:
        alb = tq.build_mip_pyramid(albedo)
        mats.append(build({
            "alb_r": [m[:, :, 0:1] for m in alb],
            "alb_g": [m[:, :, 1:2] for m in alb],
            "alb_b": [m[:, :, 2:3] for m in alb],
            "nrm_x": [n_norm[:, :, 0:1]], "nrm_y": [n_norm[:, :, 1:2]],
            "nrm_z": [n_norm[:, :, 2:3]],
            "metallic": [n_metal], "roughness": [n_rough], "ao": [n_ao],
            "height": [n_height],
        }, device=device))
    return merge(tuple(mats))


def cube_scene_materials(layout: str = "block", device="cuda",
                         with_mips: bool = True):
    """:func:`cube_material_tables` of uv_debug.png and texture.jpg from
    the resource root (``config.toml``)."""
    from bibim_tpu_torch.assets.image import load_image_rgba8
    from bibim_tpu_torch.utils.config import get_resource_root

    root = get_resource_root()
    return cube_material_tables(
        (load_image_rgba8(root.common("uv_debug.png")),
         load_image_rgba8(root.common("texture.jpg"))), layout, device,
        with_mips)
