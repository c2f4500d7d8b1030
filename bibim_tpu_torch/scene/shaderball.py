"""ShaderBallScene (port of ``bibim_tpu.scene.shaderball``).

3 lights (warm directional + 2 point lights), the 100×-scaled ground plane
at y=-10, and ShaderBall.fbx de-indexed with per-instance model matrices
``translate(2i,-1,2) · rotY(angle) · rotX(-90) · scale(0.01)``. Draw order
is ball first, then plane (equal-depth ties go to the later draw).

The scene keeps host copies of its instance matrices and mesh bounds for
the per-frame frustum cull (:meth:`ShaderBallScene.culled_scene_data`,
BASELINE config 4: 64 instances seen from :func:`instanced_camera`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from bibim_tpu_torch.scene import culling
from bibim_tpu_torch.scene.camera import FreeLookCamera
from bibim_tpu_torch.scene.lights import LightType, make_lights
from bibim_tpu_torch.scene.meshgen import Mesh, generate_plane_mesh
from bibim_tpu_torch.scene.scene import (
    DrawBatch,
    SceneBase,
    SceneData,
    batch_from_mesh,
)


def shaderball_lights(device="cuda"):
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


def _plane_model() -> np.ndarray:
    plane_model = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    plane_model[1, 3] = -10.0
    return plane_model


def ground_plane_batch(device="cuda") -> DrawBatch:
    """translate(0,-10,0) · scale(100) unit plane."""
    return batch_from_mesh(generate_plane_mesh(), _plane_model(),
                           device=device)


def instanced_camera() -> FreeLookCamera:
    """The instanced frame's camera (bench.py config 4): at (8, 6, -14),
    looking down +Z along the row of instances."""
    return FreeLookCamera(pos=np.array([8.0, 6.0, -14.0], np.float32))


def _deindexed_positions(mesh: Mesh) -> np.ndarray:
    return np.asarray(mesh.positions, np.float32)[
        np.asarray(mesh.indices, np.int64).reshape(-1)]


@dataclass
class ShaderBallScene(SceneBase):
    """``ball_mesh`` None loads ShaderBall.fbx from the resource root;
    another mesh stands in for it. ``spin`` turns the balls 30° a second
    about y in :meth:`update_scene`."""

    num_instances: int = 1
    selected_material_index: int = 1
    angle: float = -90.0
    spin: bool = False
    device: str = "cuda"
    ball_mesh: Mesh | None = field(default=None, repr=False)
    # The ball (batch 0) is the shadow caster the light frustum's XY fits
    # (RenderSettings.shadow_fit_batches); the plane still rasterizes into
    # the shadow map as an occluder and receiver.
    shadow_fit_batches = (0,)
    _plane: DrawBatch | None = field(default=None, repr=False)
    _ball: DrawBatch | None = field(default=None, repr=False)
    _lights: object = field(default=None, repr=False)
    _hosts: tuple = field(default=(), repr=False)

    def __post_init__(self):
        mesh = self.ball_mesh
        if mesh is None:
            from bibim_tpu_torch.assets.fbx import load_fbx_mesh
            from bibim_tpu_torch.utils.config import get_resource_root

            mesh = load_fbx_mesh(get_resource_root().common("ShaderBall.fbx"))
        self._plane = ground_plane_batch(self.device)
        self._ball = batch_from_mesh(mesh, device=self.device)
        self._lights = shaderball_lights(self.device)
        plane = _plane_model()[None]
        self._hosts = (
            culling.host_instances(_deindexed_positions(mesh),
                                   np.eye(4, dtype=np.float32)[None],
                                   np.eye(4, dtype=np.float32)[None]),
            culling.host_instances(
                _deindexed_positions(generate_plane_mesh()), plane,
                np.linalg.inv(plane.astype(np.float64)).astype(np.float32)))
        self._place_instances()

    def _place_instances(self) -> None:
        """The balls' model matrices at ``angle``, on the device and in
        the host copy the cull reads."""
        import torch

        model, inv = shaderball_instance_matrices(self.num_instances,
                                                  self.angle)
        self._ball = self._ball._replace(
            model=torch.as_tensor(model, device=self.device),
            inv_model=torch.as_tensor(inv, device=self.device))
        self._hosts = (self._hosts[0]._replace(model=model, inv_model=inv),
                       self._hosts[1])

    def update_scene(self, dt: float) -> None:
        if self.spin:
            self.angle += 30.0 * dt
            if self.angle > 360.0:
                self.angle -= 360.0
            self._place_instances()

    def scene_data(self) -> SceneData:
        return SceneData(batches=(self._ball, self._plane),
                         lights=self._lights)

    @property
    def host_instances(self) -> tuple:
        """Per batch, the host matrices and bounds the cull reads."""
        return self._hosts

    def culled_scene_data(self, view, proj) -> SceneData:
        """:meth:`scene_data` with each batch's instances frustum-culled
        for this camera on the host (numpy ``view`` and ``proj``)."""
        return culling.cull_scene_instances(self.scene_data(), self._hosts,
                                            view, proj)

    @property
    def selected_material(self) -> int:
        return self.selected_material_index
