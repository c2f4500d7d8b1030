"""GizmoScene (port of ``bibim_tpu.scene.gizmoscene``) — BASELINE config
1: gizmo.obj as the main mesh, flat shading (``shading="flat"``), no
lights, a fixed camera.

The reference's gizmo viewport (gizmo.vert: the camera 27 units back
along +Z, a 30° field of view) as a full-frame scene. ``mesh`` None loads
gizmo.obj from the resource root; another mesh (a coloured stand-in)
takes its place.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bibim_tpu_torch.scene.lights import make_lights
from bibim_tpu_torch.scene.meshgen import Mesh
from bibim_tpu_torch.scene.scene import SceneBase, SceneData, batch_from_mesh

GIZMO_CAMERA_DISTANCE = 27.0
GIZMO_FOV_DEGREES = 30.0


@dataclass
class GizmoScene(SceneBase):
    device: str = "cuda"
    mesh: Mesh | None = field(default=None, repr=False)
    _data: SceneData | None = field(default=None, repr=False)

    def __post_init__(self):
        mesh = self.mesh
        if mesh is None:
            from bibim_tpu_torch.assets.obj import load_obj
            from bibim_tpu_torch.utils.config import get_resource_root

            mesh = load_obj(get_resource_root().common("gizmo.obj"))
        self._data = SceneData(
            batches=(batch_from_mesh(mesh, device=self.device),),
            lights=make_lights([], device=self.device))

    def scene_data(self) -> SceneData:
        return self._data
