"""Free-look camera (reference src/camera.h/.cpp).

Host-side numpy state; produces view matrices for the frame function.
A copy of ``bibim_tpu.scene.camera`` with ``math3d_np.look_at`` inlined
(importing that module would load the JAX package's scene layer, which
imports jax).
Look vector = (-sin(yaw)cos(pitch), sin(pitch), cos(yaw)cos(pitch)) with
yaw/pitch in degrees (camera.cpp:14-20); default state Pos=0, Yaw=0, Pitch=0
looks down +Z (main.cpp:1123 zero-init).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def look_at(eye, target, up_axis=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Host-side view matrix (rows right, up, forward; +Z forward)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up_axis = np.asarray(up_axis, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up_axis, fwd)
    right = right / np.linalg.norm(right)
    up = np.cross(fwd, right)
    up = up / np.linalg.norm(up)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = right, up, fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m


@dataclass
class FreeLookCamera:
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0  # degrees
    pitch: float = 0.0  # degrees

    def get_look(self) -> np.ndarray:
        yaw = np.radians(self.yaw)
        pitch = np.radians(self.pitch)
        cp = np.cos(pitch)
        return np.asarray(
            [-np.sin(yaw) * cp, np.sin(pitch), np.cos(yaw) * cp], np.float32
        )

    def get_right(self) -> np.ndarray:
        up = np.asarray([0.0, 1.0, 0.0], np.float32)
        r = np.cross(up, self.get_look())
        return (r / np.linalg.norm(r)).astype(np.float32)

    def get_view_matrix(self) -> np.ndarray:
        return look_at(self.pos, self.pos + self.get_look())

    # --- interaction (main.cpp:1237-1262) ---

    MOUSE_SENSITIVITY = 0.6  # degrees per pixel
    MOVE_SPEED = 4.0  # units per second

    def apply_mouse_drag(self, dx_pixels: float, dy_pixels: float) -> None:
        self.yaw -= dx_pixels * self.MOUSE_SENSITIVITY
        self.pitch = float(
            np.clip(self.pitch - dy_pixels * self.MOUSE_SENSITIVITY, -88.0, 88.0)
        )

    def apply_movement(self, strafe: int, forward: int, dt: float) -> None:
        move = (
            self.get_right() * float(strafe) + self.get_look() * float(forward)
        ) * (self.MOVE_SPEED * dt)
        self.pos = (self.pos + move).astype(np.float32)
