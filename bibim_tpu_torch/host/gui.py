"""GUI-state layer (a copy of ``bibim_tpu.host.gui``): the ImGui windows
of the reference (main.cpp:1157-1316) as one dataclass.

The reference's runtime toggles are ImGui widgets: scene selector,
forward/deferred combo, G-buffer visualization combo, normal-map/tone-
mapping/TBN checkboxes, exposure slider, material/instance selectors.
Headless here, the same state lives in :class:`UiState`, mutated by CLI
flags, session events or the live viewer, and optionally persisted to
JSON.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np


@dataclass
class UiState:
    """Every runtime toggle of the reference GUI + camera pose."""

    scene: str = "shaderball"  # Scene window combo (main.cpp:1157-1171)
    deferred: bool = True  # Render Setting combo (main.cpp:1186-1199)
    gbuffer_viz: str = "scene"  # Deferred Buffer combo (main.cpp:1201-1222)
    enable_normal_map: bool = False  # Settings checkboxes (main.cpp:1305-1316)
    enable_tone_mapping: bool = False
    enable_tbn: bool = False
    show_hud: bool = False  # in-frame stats text (ImGui-overlay analog)
    # BASELINE config 5's passes (bench.py bench_stretch_4k): the shadow
    # map of light 0 (directional) with 2 x 2 PCF, and the split-sum IBL
    # ambient in place of the constant one.
    enable_shadows: bool = False
    enable_ibl: bool = False
    exposure: float = 1.0  # slider 0.1..10
    # N-tap in-level-0 anisotropic sampling (the reference sampler's
    # maxAnisotropy, kept opt-in); 1 = plain bilinear parity.
    aniso_taps: int = 1
    selected_material: int = 1  # Material Selector (scene.cpp:141-151)
    mesh_path: str = ""  # --scene mesh asset (MeshScene)
    selected_instance: int = -1  # Shader Balls window (scene.cpp:131-139)
    num_instances: int = 1
    # FreeLookCamera pose (camera.h:6-14)
    camera_pos: tuple = (0.0, 0.0, 0.0)
    camera_yaw: float = 0.0
    camera_pitch: float = 0.0

    def clamp(self) -> None:
        self.exposure = float(np.clip(self.exposure, 0.1, 10.0))
        self.camera_pitch = float(np.clip(self.camera_pitch, -88.0, 88.0))
        self.aniso_taps = int(np.clip(int(self.aniso_taps), 1, 16))

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(asdict(self), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "UiState":
        data = json.loads(Path(path).read_text())
        state = cls(**data)
        state.camera_pos = tuple(state.camera_pos)
        state.clamp()
        return state
