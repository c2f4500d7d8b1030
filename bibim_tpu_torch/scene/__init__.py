"""Scene layer: draw batches, lights, camera, input state and the ported
scenes.

The ShaderBall scene is imported from its own module on demand (it loads
ShaderBall.fbx when constructed)."""

from bibim_tpu_torch.scene.camera import FreeLookCamera
from bibim_tpu_torch.scene.input import Input
from bibim_tpu_torch.scene.lights import (
    LightType,
    Lights,
    MAX_NUM_LIGHTS,
    make_lights,
)
from bibim_tpu_torch.scene.scene import (
    DrawBatch,
    RenderPassType,
    SceneBase,
    SceneData,
    batch_from_mesh,
)
from bibim_tpu_torch.scene.triangle import TriangleScene

__all__ = [
    "DrawBatch",
    "FreeLookCamera",
    "Input",
    "LightType",
    "Lights",
    "MAX_NUM_LIGHTS",
    "RenderPassType",
    "SceneBase",
    "SceneData",
    "TriangleScene",
    "batch_from_mesh",
    "make_lights",
]
