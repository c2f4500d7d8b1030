"""MeshScene (port of ``bibim_tpu.scene.meshscene``): one OBJ or binary
FBX file, auto-framed in front of the default camera (centred, scaled to
a ~1.5 radius, pushed to z = 4) and lit by the three-light rig of the JAX
package's MeshScene, on the port's own loaders (``assets.obj``,
``assets.fbx``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bibim_tpu_torch.scene.lights import LightType, make_lights
from bibim_tpu_torch.scene.scene import SceneBase, SceneData, batch_from_mesh


def load_mesh_any(path):
    """OBJ or binary FBX, by the file's extension."""
    p = Path(path)
    if p.suffix.lower() == ".obj":
        from bibim_tpu_torch.assets.obj import load_obj

        return load_obj(p)
    if p.suffix.lower() == ".fbx":
        from bibim_tpu_torch.assets.fbx import load_fbx_mesh

        return load_fbx_mesh(p)
    raise ValueError(f"unsupported mesh format: {p.suffix!r} (obj/fbx)")


@dataclass
class MeshScene(SceneBase):
    """One imported mesh; ``spin`` turns it 30° a second about y in
    :meth:`update_scene`."""

    path: str = ""
    scale: float = 1.0
    spin: bool = False
    angle: float = 0.0
    device: str = "cuda"
    _batch: object = field(default=None, repr=False)
    _lights: object = field(default=None, repr=False)
    _bounds: tuple = field(default=None, repr=False)

    def __post_init__(self):
        mesh = load_mesh_any(self.path)
        lo = mesh.positions.min(axis=0)
        hi = mesh.positions.max(axis=0)
        radius = float(np.linalg.norm(hi - lo) * 0.5) or 1.0
        self._norm_scale = 1.5 / radius * self.scale
        self._center = (lo + hi) * 0.5
        self._batch = batch_from_mesh(mesh, self._model(), device=self.device)
        self._bounds = (lo, hi)
        self._lights = make_lights([
            dict(type=LightType.DIRECTIONAL, dir=(-0.3, -1.0, 0.5),
                 color=(1, 1, 1), intensity=2.5),
            dict(type=LightType.POINT, pos=(3, 3, 0), color=(1, 0.9, 0.8),
                 intensity=12.0),
            dict(type=LightType.POINT, pos=(-3, 2, 1),
                 color=(0.6, 0.7, 1.0), intensity=8.0),
        ], device=self.device)

    def _model(self) -> np.ndarray:
        s = self._norm_scale
        a = np.radians(self.angle)
        c, sn = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, -sn, 0], [0, 1, 0, 0], [sn, 0, c, 0],
                        [0, 0, 0, 1]], np.float32)
        scale = np.diag([s, s, s, 1.0]).astype(np.float32)
        trans = np.eye(4, dtype=np.float32)
        trans[:3, 3] = -self._center
        place = np.eye(4, dtype=np.float32)
        place[2, 3] = 4.0  # in front of the default camera (+Z look)
        return place @ rot @ scale @ trans

    def update_scene(self, dt: float) -> None:
        if self.spin:
            self.angle += 30.0 * dt
            model = self._model()[None]
            inv = np.linalg.inv(model.astype(np.float64)).astype(np.float32)
            dev = self._batch.model.device
            self._batch = self._batch._replace(
                model=torch.as_tensor(np.asarray(model, np.float32),
                                      device=dev),
                inv_model=torch.as_tensor(inv, device=dev))

    def scene_data(self) -> SceneData:
        return SceneData(batches=(self._batch,), lights=self._lights)

    @property
    def selected_material(self) -> int:
        return 0
