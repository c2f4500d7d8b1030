"""3D math conventions as PyTorch tensor ops (port of ``bibim_tpu.math3d``).

Matrices are ``(..., 4, 4)`` float32 tensors in row-major math notation:
``v' = M @ v`` with translation in the last column, rotations in degrees,
``look_at`` +Z-forward, ``perspective`` the Vulkan-style reversed-Z
projection with Y negated (near → depth 1, far → depth 0).
"""

from __future__ import annotations

import torch

PI32 = 3.14159265358979323846

_F32 = torch.float32


def _t(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=_F32, device=device or x.device)
    return torch.as_tensor(x, dtype=_F32, device=device)


def deg_to_rad(degrees, device=None) -> torch.Tensor:
    return _t(degrees, device) * (PI32 / 180.0)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| along the last axis (no epsilon guard, like the reference)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def translate(delta, device=None) -> torch.Tensor:
    delta = _t(delta, device)
    m = torch.eye(4, dtype=_F32, device=delta.device)
    m = m.expand(delta.shape[:-1] + (4, 4)).clone()
    m[..., :3, 3] = delta
    return m


def scale(s, device=None) -> torch.Tensor:
    s = _t(s, device)
    if s.ndim == 0:
        s = torch.stack([s, s, s])
    d = torch.cat([s, torch.ones(s.shape[:-1] + (1,), dtype=_F32,
                                 device=s.device)], dim=-1)
    return torch.diag_embed(d)


def _rot(c: torch.Tensor, s: torch.Tensor, axis: int) -> torch.Tensor:
    o = torch.ones_like(c)
    z = torch.zeros_like(c)
    if axis == 0:
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]]
    elif axis == 1:
        rows = [[c, z, -s, z], [z, o, z, z], [s, z, c, z], [z, z, z, o]]
    else:
        rows = [[c, -s, z, z], [s, c, z, z], [z, z, o, z], [z, z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_x(degrees, device=None) -> torch.Tensor:
    r = deg_to_rad(degrees, device)
    return _rot(torch.cos(r), torch.sin(r), 0)


def rotate_y(degrees, device=None) -> torch.Tensor:
    r = deg_to_rad(degrees, device)
    return _rot(torch.cos(r), torch.sin(r), 1)


def rotate_z(degrees, device=None) -> torch.Tensor:
    r = deg_to_rad(degrees, device)
    return _rot(torch.cos(r), torch.sin(r), 2)


def look_at(eye, target, up_axis=(0.0, 1.0, 0.0), device=None):
    """View matrix: rows right, up, forward; +Z forward."""
    eye = _t(eye, device)
    target = _t(target, eye.device)
    up_axis = _t(up_axis, eye.device)
    fwd = normalize(target - eye)
    right = normalize(torch.linalg.cross(up_axis.expand_as(fwd), fwd))
    up = normalize(torch.linalg.cross(fwd, right))
    rows = torch.stack([right, up, fwd], dim=-2)
    trans = -(rows @ eye.unsqueeze(-1)).squeeze(-1)
    m = torch.cat([rows, trans.unsqueeze(-1)], dim=-1)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=_F32,
                        device=eye.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([m, last], dim=-2)


def perspective(fov_degrees, aspect, near, far, device=None):
    """Reversed-Z perspective (near plane → depth 1, far plane → 0)."""
    d = 1.0 / torch.tan(deg_to_rad(fov_degrees, device) * 0.5)
    f_sub_n = far - near
    z = torch.zeros_like(d)
    o = torch.ones_like(d)
    rows = [
        [d / aspect, z, z, z],
        [z, -d, z, z],
        [z, z, (-near / f_sub_n) * o, (near * far / f_sub_n) * o],
        [z, z, o, z],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-f32 matrix product (TF32 stays off for float32 matmuls)."""
    return torch.matmul(a, b)


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Analytic 4×4 inverse by cofactor expansion (batched, elementwise)."""

    def minor_det(r: int, c: int):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a, b, cc = (m[..., rows[0], cols[k]] for k in range(3))
        d, e, f = (m[..., rows[1], cols[k]] for k in range(3))
        g, h, i = (m[..., rows[2], cols[k]] for k in range(3))
        return a * (e * i - f * h) - b * (d * i - f * g) + cc * (d * h - e * g)

    cof = torch.stack([
        torch.stack([((-1.0) ** (r + c)) * minor_det(r, c) for c in range(4)],
                    dim=-1)
        for r in range(4)
    ], dim=-2)
    det = torch.sum(m[..., 0, :] * cof[..., 0, :], dim=-1)
    return cof.transpose(-1, -2) / det[..., None, None]


def normal_matrix(inv_model: torch.Tensor) -> torch.Tensor:
    """transpose(mat3(InvModel)) — the world-space normal transform."""
    return inv_model[..., :3, :3].transpose(-1, -2)
