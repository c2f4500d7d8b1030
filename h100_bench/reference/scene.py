"""The ShaderBall scene as the reference renderer defines it
(bibim-renderer src/scene.cpp:18-51, main.cpp:1123-1262), in plain numpy
and PyTorch: camera, projection, lights, instance matrices, the ground
plane, the light spheres and the gizmo viewport camera.

Imports neither the program nor the JAX package; the formulas and their
operation order are those the program documents for its frame (reversed-Z
projection with Y negated, +Z-forward look-at, model =
translate(2i, -1, 2) · rotY(angle) · rotX(-90) · scale(0.01)), so that the
two agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

PI32 = 3.14159265358979323846
# Camera (main.cpp:1123, camera.h): 60° vertical field of view, near 0.1,
# far 1000.
FOV_DEGREES = 60.0
NEAR, FAR = 0.1, 1000.0
# The gizmo viewport (main.cpp:1340-1381): the main view's rotation from
# 27 units back along the look vector, 30° field of view.
GIZMO_BACK = -27.0
GIZMO_HALF_FOV_RAD = 0.261799
LIGHT_SPHERE = (0.1, 16, 16)  # radius, divisions (scene.cpp light spheres)

POINT, SPOT, DIRECTIONAL = 0, 1, 2


def shaderball_lights() -> list:
    """scene.cpp:18-51: a warm directional light and two point lights (the
    second with cutoffs that a point light does not read)."""
    d2r = np.pi / 180.0
    return [
        dict(type=DIRECTIONAL, dir=(-1, -1, 0),
             color=(0.2347, 0.2131, 0.2079), intensity=10.0),
        dict(type=POINT, pos=(0, 2, 0), color=(1, 0.8, 0.8), intensity=50),
        dict(type=POINT, pos=(4, 2, 0), dir=(0, -1, 0), color=(0.8, 1, 0.8),
             intensity=50, inner_cutoff=30 * d2r, outer_cutoff=25 * d2r),
    ]


def light_arrays(entries: list) -> dict:
    """Struct-of-arrays float32 numpy light fields (missing fields 0)."""
    n = len(entries)

    def col(key, width):
        out = np.zeros((n, width) if width > 1 else (n,), np.float32)
        for i, e in enumerate(entries):
            if key in e:
                out[i] = np.asarray(e[key], np.float32)
        return out

    return dict(pos=col("pos", 3), dir=col("dir", 3),
                type=np.asarray([int(e.get("type", POINT)) for e in entries],
                                np.int32),
                intensity=col("intensity", 1), color=col("color", 3),
                inner_cutoff=col("inner_cutoff", 1),
                outer_cutoff=col("outer_cutoff", 1))


def instance_matrices(num_instances: int, angle_degrees: float = -90.0):
    """(I, 4, 4) float32 model matrices and their float64-computed
    inverses: translate(2i, -1, 2) · rotY(angle) · rotX(-90) · 0.01."""
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


def plane_matrices():
    """The ground plane: translate(0, -10, 0) · scale(100)."""
    m = np.diag([100.0, 100.0, 100.0, 1.0]).astype(np.float32)
    m[1, 3] = -10.0
    inv = np.linalg.inv(m[None].astype(np.float64)).astype(np.float32)
    return m[None], inv


def camera_look(yaw: float, pitch: float) -> np.ndarray:
    """camera.cpp:14-20, yaw and pitch in degrees."""
    yaw, pitch = np.radians(yaw), np.radians(pitch)
    cp = np.cos(pitch)
    return np.asarray([-np.sin(yaw) * cp, np.sin(pitch), np.cos(yaw) * cp],
                      np.float32)


def look_at(eye, target, up_axis=(0.0, 1.0, 0.0)) -> np.ndarray:
    """View matrix with rows right, up, forward (+Z forward)."""
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


def view_matrix(pos, yaw: float, pitch: float) -> np.ndarray:
    pos = np.asarray(pos, np.float32)
    return look_at(pos, pos + camera_look(yaw, pitch))


def perspective(aspect: float) -> torch.Tensor:
    """Reversed-Z perspective on the CPU in float32 (near → 1, far → 0,
    Y negated)."""
    d = 1.0 / torch.tan(torch.as_tensor(FOV_DEGREES, dtype=torch.float32)
                        * (PI32 / 180.0) * 0.5)
    f_sub_n = FAR - NEAR
    z = torch.zeros_like(d)
    o = torch.ones_like(d)
    rows = [
        [d / aspect, z, z, z],
        [z, -d, z, z],
        [z, z, (-NEAR / f_sub_n) * o, (NEAR * FAR / f_sub_n) * o],
        [z, z, o, z],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def gizmo_camera(view: torch.Tensor, proj: torch.Tensor):
    """The gizmo viewport's (view, view-projection) from the main view
    and projection (device tensors)."""
    rot = view[:3, :3]
    look = view[2, :3]
    view_pos = look * GIZMO_BACK
    trans = -(rot @ view_pos)
    gz_view = view.clone()
    gz_view[:3, 3] = trans
    d = 1.0 / torch.tan(torch.tensor(GIZMO_HALF_FOV_RAD, dtype=view.dtype,
                                     device=view.device))
    gz_proj = proj.clone()
    gz_proj[0, 0] = d
    gz_proj[1, 1] = -d
    return gz_view, torch.matmul(gz_proj, gz_view)
