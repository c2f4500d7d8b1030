"""Interactive render session (port of ``bibim_tpu.host.session``) — the
live frame loop of main.cpp:1131-1381.

The reference's loop is: SDL events → Input → ImGui state → camera update →
scene update → record + submit → present. This session reproduces that
control flow headlessly:

- an *event source* (scripted replay, tests, or the live viewer) feeds
  key/mouse/state events per frame,
- :class:`Input` accumulates them (src/input.h analog),
- the free-look camera consumes drag (0.6°/px, pitch clamp ±88°) and WASD
  (4 u/s) exactly like main.cpp:1237-1262,
- scenes are constructed lazily on first selection and kept alive for
  switching without restart (main.cpp:1173-1182),
- material selection rebinds the material tables (scene.cpp:141-151),
- frames are dispatched with 2-deep readback (numFrames=2, main.cpp:38):
  the frame's kernels queue on the card, and the host gets the frame
  before it back (:class:`~bibim_tpu_torch.host.readback.
  DoubleBufferedReadback`).

The session's tensors live on ``device`` ("cuda" unless the caller asks for
"cpu"). Its per-frame inputs (view matrix, camera position, toggles, the
HUD mask) go to a CUDA device from pinned memory without a host wait, and
the capacity diagnostics of a frame reach the host through the same
readback as its image, so that the drop watcher reads only completed
frames.

Event script format (JSON list; replay with ``Session.run_script``):
    [{"frame": 0, "key": "w", "down": true},
     {"frame": 2, "cursor": [40, 10], "mouse": true},
     {"frame": 5, "set": {"scene": "gizmo", "exposure": 2.0}}]
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.host.gui import UiState
from bibim_tpu_torch.host.readback import DoubleBufferedReadback
from bibim_tpu_torch.pipeline import (
    FrameParams,
    GBufferViz,
    RenderSettings,
    ViewBlock,
    make_overlay_resources,
    material_quads_from_set,
    render_frame,
)
from bibim_tpu_torch.scene.camera import FreeLookCamera
from bibim_tpu_torch.scene.input import Input
from bibim_tpu_torch.utils.log import log_info
from bibim_tpu_torch.utils.profiling import FrameStats

VIZ_BY_NAME = {
    "position": GBufferViz.POSITION,
    "normal": GBufferViz.NORMAL,
    "albedo": GBufferViz.ALBEDO,
    "mrha": GBufferViz.MRHA,
    "matindex": GBufferViz.MATERIAL_INDEX,
    "scene": GBufferViz.RENDERED_SCENE,
}

# The caps a retune derives (pipeline.autotune), merged into the previous
# derivation of the same scene and size by the session's rule (_retune).
TUNED_CAPS = ("max_candidates", "raster_passes", "overflow_cap",
              "pair_budget", "live_tile_cap", "raster_tile_cap",
              "overlay_candidates", "overlay_max_tiles",
              "overlay_overflow_cap", "span_cap", "span_mid_cap")
# Routing choices whose overflow is validated apart (the overflow list,
# dropped_pairs): always the fresh derivation.
FRESH_CAPS = ("span_cap", "span_mid_cap")


def _make_scene(name: str, ui: UiState, device):
    if name == "triangle":
        from bibim_tpu_torch.scene.triangle import TriangleScene

        return TriangleScene(device=device)
    if name == "shaderball":
        from bibim_tpu_torch.scene.shaderball import ShaderBallScene

        return ShaderBallScene(num_instances=max(1, ui.num_instances),
                               device=device)
    if name == "gizmo":
        from bibim_tpu_torch.scene.gizmoscene import GizmoScene

        return GizmoScene(device=device)
    if name == "cube":
        from bibim_tpu_torch.scene.cube import CubeScene

        return CubeScene(device=device)
    if name == "mesh":
        from bibim_tpu_torch.scene.meshscene import MeshScene

        if not ui.mesh_path:
            raise ValueError("scene 'mesh' needs UiState.mesh_path")
        return MeshScene(path=ui.mesh_path, device=device)
    raise ValueError(f"unknown scene {name!r}")


def merge_caps(old: dict | None, derived: RenderSettings) -> dict:
    """The session's retune rule: the :data:`TUNED_CAPS` of a fresh
    derivation, each grown to the previous derivation's value (None =
    uncapped, never shrunk to a cap), except :data:`FRESH_CAPS`, taken
    fresh. Caps only ever grow, so a camera oscillating across a bucket
    edge cannot thrash."""
    caps = {k: getattr(derived, k) for k in TUNED_CAPS}
    if old is not None:
        for k, v in caps.items():
            if k in FRESH_CAPS:
                continue
            caps[k] = None if old[k] is None or v is None else max(old[k], v)
    return caps


def upload(a, dtype, device) -> torch.Tensor:
    """Host data as a tensor on ``device``; to a CUDA device from pinned
    memory with ``non_blocking=True``, so the host does not wait for the
    frames in flight."""
    t = torch.as_tensor(np.asarray(a), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _diag_values(diag, device) -> torch.Tensor:
    """A frame's BinDiag as one (4,) int64 device tensor (no host wait)."""
    return torch.stack([
        (leaf if isinstance(leaf, torch.Tensor)
         else torch.full((), int(leaf), device=device)).to(
            torch.int64).reshape(())
        for leaf in diag])


@dataclass
class Session:
    """Owns the mutable host state of one interactive run."""

    width: int = 1280
    height: int = 720
    ui: UiState = field(default_factory=UiState)
    readback_depth: int = 2
    device: str = "cuda"

    def __post_init__(self):
        self._dev = torch.device(self.device)
        if self._dev.type == "cuda":
            # Without a card this raises torch's own error.
            torch.cuda.init()
        self.input = Input()
        self.camera = FreeLookCamera(
            pos=np.asarray(self.ui.camera_pos, np.float32),
            yaw=self.ui.camera_yaw,
            pitch=self.ui.camera_pitch,
        )
        self._scenes: dict = {}  # lazy construction (main.cpp:1173-1182)
        self._material_set = None
        self._materials: dict = {}  # material index → tables
        self._overlay = None
        self._hud_geom = None
        self._proj = None  # (width, height, tensor)
        self.readback = DoubleBufferedReadback(depth=self.readback_depth)
        self.stats = FrameStats()
        # Adaptive capacities (pipeline.autotune): derived caps per scene
        # binding, re-probed (monotonically raised) when a completed
        # frame's diagnostics report drops.
        self._tuned: dict = {}
        self.retunes: list = []  # (tune key, caps) of every retune
        self._pending: list = []  # (scene data, view block) in flight

    # -- resource binding ---------------------------------------------------

    @property
    def scene(self):
        name = self.ui.scene
        # Instance count is part of the scene identity (the viewer's
        # instance selector rebuilds the ShaderBall scene).
        key = (name,
               self.ui.num_instances if name == "shaderball" else 0)
        if key not in self._scenes:
            self._scenes[key] = _make_scene(name, self.ui, self._dev)
        return self._scenes[key]

    def material_set(self):
        if self._material_set is None:
            from bibim_tpu_torch.assets.materials import (
                create_pbr_material_set,
            )

            self._material_set = create_pbr_material_set()
        return self._material_set

    def materials(self):
        if self.ui.scene == "cube":
            from bibim_tpu_torch.scene.cube import cube_scene_materials

            key = "cube"
            if key not in self._materials:
                self._materials[key] = cube_scene_materials(device=self._dev)
            return self._materials[key]
        idx = self.ui.selected_material
        if idx not in self._materials:
            self._materials[idx] = material_quads_from_set(
                self.material_set(), idx, device=self._dev)
        return self._materials[idx]

    def overlay(self):
        if self._overlay is None:
            self._overlay = make_overlay_resources(device=self._dev)
        return self._overlay

    # -- event handling (SDL_PollEvent analog, main.cpp:1132-1147) ----------

    def handle_event(self, ev: dict) -> None:
        if "key" in ev:
            self.input.process_key_event(ev["key"], bool(ev.get("down", True)))
        if "mouse" in ev:
            self.input.mouse_down = bool(ev["mouse"])
        if "cursor" in ev:
            x, y = ev["cursor"]
            self.input.update_cursor(int(x), int(y))
        if "set" in ev:
            fields = dict(ev["set"])
            if "size" in fields:
                w, h = fields.pop("size")
                self.resize(int(w), int(h))
            for k, v in fields.items():
                if not hasattr(self.ui, k):
                    raise ValueError(f"unknown ui field {k!r}")
                setattr(self.ui, k, v)
            self.ui.clamp()

    def resize(self, width: int, height: int) -> None:
        """Live resize mid-loop — the swapchain-recreation analog
        (onWindowResize, main.cpp:1042-1070): the next frame renders at
        the new extent; size-derived host state (HUD geometry, the
        projection, probed caps) is dropped. Frames already in flight at
        the old size drain through the readback unchanged."""
        if (width, height) == (self.width, self.height):
            return
        self.width, self.height = width, height
        self._hud_geom = None
        self._proj = None
        # Probed capacities are resolution-specific; _tune_key includes
        # the size, so stale entries are unreachable — drop them anyway.
        self._tuned.clear()
        log_info("resized to {}x{} (reloadable resources rebuild on next "
                 "frame)", width, height)

    def _update_camera(self, dt: float) -> None:
        """main.cpp:1237-1262: drag rotates, WASD moves."""
        if self.input.mouse_down:
            dx, dy = self.input.cursor_delta
            self.camera.apply_mouse_drag(dx, dy)
        self.input.cursor_delta = (0, 0)
        strafe, forward = self.input.movement_direction()
        if strafe or forward:
            self.camera.apply_movement(strafe, forward, dt)

    # -- frame --------------------------------------------------------------

    def _upload(self, a, dtype) -> torch.Tensor:
        return upload(a, dtype, self._dev)

    def view_block(self) -> ViewBlock:
        """The camera's view block: 60° vertical field of view, near 0.1,
        far 1000 (the projection built on the host once per size)."""
        if self._proj is None or self._proj[:2] != (self.width, self.height):
            proj = m3.perspective(60.0, self.width / self.height, 0.1,
                                  1000.0, device="cpu")
            self._proj = (self.width, self.height,
                          self._upload(proj, torch.float32))
        return ViewBlock(
            view=self._upload(self.camera.get_view_matrix(), torch.float32),
            proj=self._proj[2],
            view_pos=self._upload(self.camera.pos, torch.float32),
            enable_normal_map=self._upload(
                1 if self.ui.enable_normal_map else 0, torch.int32),
        )

    def frame_params(self) -> FrameParams:
        return FrameParams(
            enable_tone_mapping=self._upload(
                1 if self.ui.enable_tone_mapping else 0, torch.int32),
            exposure=self._upload(self.ui.exposure, torch.float32),
        )

    def _base_settings(self) -> RenderSettings:
        return RenderSettings(
            width=self.width,
            height=self.height,
            deferred=self.ui.deferred,
            shading="flat" if self.ui.scene == "gizmo" else "pbr",
            gbuffer_viz=VIZ_BY_NAME[self.ui.gbuffer_viz],
            show_tbn=self.ui.enable_tbn,
            show_hud=self.ui.show_hud,
            aniso_taps=self.ui.aniso_taps,
            batch_material_ids=getattr(self.scene, "material_ids", None),
            # Compacted shading + the capacity scalars for the drop
            # watcher (they ride the image's readback).
            outputs="image+diag",
        )

    def _tune_key(self):
        return (self.ui.scene, self.ui.num_instances, self.width,
                self.height)

    def settings(self) -> RenderSettings:
        """The live loop's settings: the UI's toggles with the capacities
        autotuned for the bound scene and size (pass-0 grid compaction,
        coverage-compacted shading)."""
        base = self._base_settings()
        tuned = self._tuned.get(self._tune_key())
        if tuned is not None:
            base = dataclasses.replace(base, **tuned)
        return base

    def _retune(self, scene_data, view_block) -> None:
        """(Re-)derive adaptive caps for the current scene + camera and
        merge them into the previous derivation (:func:`merge_caps`)."""
        from bibim_tpu_torch.pipeline.autotune import autotune_settings

        derived, probe = autotune_settings(
            scene_data, view_block, self._base_settings(),
            overlay=self.overlay(),
        )
        key = self._tune_key()
        caps = merge_caps(self._tuned.get(key), derived)
        self._tuned[key] = caps
        self.retunes.append((key, dict(caps)))
        log_info("autotuned caps for {}: {} (probe: {} covered tiles, "
                 "{} pairs, worst tile {})", self.ui.scene, caps,
                 probe.covered_tiles, probe.total_pairs,
                 probe.max_candidates)

    def _hud(self):
        """Per-frame HUD payload: cached static cell geometry + the lit
        mask for this frame's stats line (FPS + camera pose — the debug
        text the reference shows in its ImGui windows), the mask on the
        session's device."""
        if not self.ui.show_hud:
            return None
        from bibim_tpu_torch.host.hud import build_hud_geometry, hud_text_mask

        if self._hud_geom is None:
            self._hud_geom = build_hud_geometry(self.width, self.height)
        p = self.camera.pos
        text = (f"{self.stats.fps:5.1f} FPS  POS {p[0]:.1f} {p[1]:.1f} "
                f"{p[2]:.1f}  YAW {self.camera.yaw:.0f} "
                f"PITCH {self.camera.pitch:.0f}")
        if self.ui.selected_instance >= 0:
            # Shader Balls window's instance tracker (scene.cpp:131-139).
            text += f"  INST {self.ui.selected_instance}"
        mask = hud_text_mask(text, self._hud_geom.max_chars)
        return (self._hud_geom, self._upload(mask, torch.float32))

    def render(self, dt: float = 1 / 60):
        """One loop iteration: camera ← input, scene update, dispatch.

        Returns the host image of the frame readied this iteration
        (``readback_depth - 1`` frames behind the dispatch, or None while
        the pipeline fills)."""
        self._update_camera(dt)
        scene = self.scene
        scene.update_scene(dt)
        view_block = self.view_block()
        data = scene.scene_data()
        if self._tune_key() not in self._tuned:
            self._retune(data, view_block)
        out = render_frame(
            data, view_block, self.frame_params(), self.materials(),
            self.overlay(), self.settings(), hud=self._hud(),
        )
        self.stats.tick()
        done = self.readback.submit(
            (out["image"], _diag_values(out["bin_diag"], self._dev)))
        self._pending.append((data, view_block))
        if done is None:
            return None
        img, dropped = done
        d_data, d_view = self._pending.pop(0)
        if dropped.any():
            # A completed frame overflowed a derived cap: raise the
            # buckets from a fresh probe at that camera. The frame itself
            # is the one-frame glitch the margin didn't cover; subsequent
            # frames render complete again.
            log_info("frame reported dropped geometry — re-probing "
                     "capacities")
            self._retune(d_data, d_view)
        return img

    def flush(self) -> list:
        """Drain the frames in flight (oldest first) as host images."""
        self._pending.clear()
        return [img for img, _ in self.readback.flush()]

    def run_script(self, events, n_frames: int, dt: float = 1 / 60):
        """Replay a recorded event stream over ``n_frames`` frames and
        yield every completed host frame (the scripted-session analog of
        the reference's live loop)."""
        if isinstance(events, (str, Path)):
            events = json.loads(Path(events).read_text())
        by_frame: dict[int, list] = {}
        for ev in events:
            by_frame.setdefault(int(ev.get("frame", 0)), []).append(ev)
        for f in range(n_frames):
            for ev in by_frame.get(f, []):
                self.handle_event(ev)
            img = self.render(dt)
            if img is not None:
                yield img
        yield from self.flush()


def material_preview_strip(material_set, idx: int,
                           tile: int = 128) -> np.ndarray:
    """One material's PBR maps as a (tile, 6·tile, 3) uint8 strip, one
    tile per map type left to right in PBRMapType order (the ImGui
    material preview analog, scene.cpp:152-168)."""
    from PIL import Image

    from bibim_tpu_torch.assets.materials import PBRMapType

    cols = list(PBRMapType)
    strip = np.zeros((tile, len(cols) * tile, 3), np.uint8)
    for ci, t in enumerate(cols):
        img = np.asarray(material_set.get_pbr_map_or_default(idx, t)[0])
        im = Image.fromarray(img[:, :, :3]).resize((tile, tile),
                                                   Image.BILINEAR)
        strip[:, ci * tile:(ci + 1) * tile] = np.asarray(im)
    return strip


def save_material_previews(material_set, out_path: str,
                           tile: int = 128) -> str:
    """Material-map contact sheet — the ImGui material preview analog
    (scene.cpp:128-170): one row per material, one column per PBR map."""
    from PIL import Image

    from bibim_tpu_torch.assets.materials import PBRMapType

    names = list(material_set.names)
    sheet = np.zeros((len(names) * tile, len(PBRMapType) * tile, 3),
                     np.uint8)
    for mi in range(len(names)):
        sheet[mi * tile:(mi + 1) * tile] = material_preview_strip(
            material_set, mi, tile)
    Image.fromarray(sheet).save(out_path)
    log_info("material previews ({} × {}) → {}",
             len(names), [t.name.lower() for t in PBRMapType], out_path)
    return out_path
