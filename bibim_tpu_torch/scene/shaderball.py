"""ShaderBallScene (port of ``bibim_tpu.scene.shaderball``).

3 lights (warm directional + 2 point lights), the 100×-scaled ground plane
at y=-10, and ShaderBall.fbx de-indexed with per-instance model matrices
``translate(2i,-1,2) · rotY(angle) · rotX(-90) · scale(0.01)``. Draw order
is ball first, then plane (equal-depth ties go to the later draw).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from bibim_tpu_torch.scene.lights import LightType, make_lights
from bibim_tpu_torch.scene.meshgen import generate_plane_mesh
from bibim_tpu_torch.scene.scene import DrawBatch, SceneData, batch_from_mesh


def shaderball_lights(device="cpu"):
    d2r = np.pi / 180.0
    return make_lights([
        dict(type=LightType.DIRECTIONAL, dir=(-1, -1, 0),
             color=(0.2347, 0.2131, 0.2079), intensity=10.0),
        dict(type=LightType.POINT, pos=(0, 2, 0), color=(1, 0.8, 0.8),
             intensity=50),
        dict(type=LightType.POINT, pos=(4, 2, 0), dir=(0, -1, 0),
             color=(0.8, 1, 0.8), intensity=50,
             inner_cutoff=30 * d2r, outer_cutoff=25 * d2r),
    ], device=device)


def shaderball_instance_matrices(num_instances: int, angle_degrees):
    """Host-side (I,4,4) model matrices and their inverses, float32 numpy."""
    a = np.radians(float(angle_degrees))
    ca, sa = np.cos(a), np.sin(a)
    rot_y = np.array(
        [[ca, 0, -sa, 0], [0, 1, 0, 0], [sa, 0, ca, 0], [0, 0, 0, 1]],
        np.float64)
    rot_x_neg90 = np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)
    rot = rot_y @ rot_x_neg90 * 0.01
    rot[3, 3] = 1.0
    model = np.tile(np.eye(4), (num_instances, 1, 1))
    model[:, :4, :4] = rot
    model[:, 0, 3] = 2.0 * np.arange(num_instances)
    model[:, 1, 3] = -1.0
    model[:, 2, 3] = 2.0
    inv = np.linalg.inv(model)
    return model.astype(np.float32), inv.astype(np.float32)


def ground_plane_batch(device="cpu") -> DrawBatch:
    """translate(0,-10,0) · scale(100) unit plane."""
    plane_model = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane_model[1, 3] = -10.0
    return batch_from_mesh(generate_plane_mesh(), plane_model, device=device)


@dataclass
class ShaderBallScene:
    num_instances: int = 1
    selected_material_index: int = 1
    angle: float = -90.0
    device: str = "cpu"
    _plane: DrawBatch | None = field(default=None, repr=False)
    _ball: DrawBatch | None = field(default=None, repr=False)
    _lights: object = field(default=None, repr=False)

    def __post_init__(self):
        import torch

        from bibim_tpu.assets.fbx import load_fbx_mesh
        from bibim_tpu.utils.config import get_resource_root

        self._plane = ground_plane_batch(self.device)
        ball_mesh = load_fbx_mesh(get_resource_root().common("ShaderBall.fbx"))
        self._ball = batch_from_mesh(ball_mesh, device=self.device)
        self._lights = shaderball_lights(self.device)
        model, inv = shaderball_instance_matrices(self.num_instances,
                                                  self.angle)
        self._ball = self._ball._replace(
            model=torch.as_tensor(model, device=self.device),
            inv_model=torch.as_tensor(inv, device=self.device))

    def scene_data(self) -> SceneData:
        return SceneData(batches=(self._ball, self._plane),
                         lights=self._lights)

    @property
    def selected_material(self) -> int:
        return self.selected_material_index
