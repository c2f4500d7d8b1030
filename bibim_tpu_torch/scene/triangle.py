"""TriangleScene (port of ``bibim_tpu.scene.triangle``): three vertices at
z=5, one dim directional light, identity instance, material 0."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from bibim_tpu_torch.scene.lights import LightType, make_lights
from bibim_tpu_torch.scene.meshgen import Mesh
from bibim_tpu_torch.scene.scene import SceneData, batch_from_mesh


@dataclass
class TriangleScene:
    device: str = "cpu"
    _data: SceneData | None = field(default=None, repr=False)

    def __post_init__(self):
        # Positions + UVs only; normal/tangent take the vertex defaults
        # (0,0,-1) / (0,-1,0).
        f32 = np.float32
        mesh = Mesh(
            positions=np.asarray([(0, 1, 5), (1, -1, 5), (-1, -1, 5)], f32),
            uvs=np.asarray([(0.5, 1), (1, 0), (0, 0)], f32),
            normals=np.asarray([(0, 0, -1)] * 3, f32),
            tangents=np.asarray([(0, -1, 0)] * 3, f32),
            indices=np.asarray([(0, 1, 2)], np.int32),
        )
        lights = make_lights([
            dict(type=LightType.DIRECTIONAL, dir=(-1, -1, 0),
                 color=(0.0347, 0.0131, 0.2079), intensity=10.0),
        ], device=self.device)
        self._data = SceneData(
            batches=(batch_from_mesh(mesh, device=self.device),),
            lights=lights)

    def scene_data(self) -> SceneData:
        return self._data

    @property
    def selected_material(self) -> int:
        return 0
