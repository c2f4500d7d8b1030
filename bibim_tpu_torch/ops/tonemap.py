"""Tone mapping and output encode (port of ``bibim_tpu.ops.tonemap``):
exposure map ``1 − exp(−hdr·exposure)`` behind a toggle, the sRGB OETF of
the reference's SRGB swapchain, and u8 quantization."""

from __future__ import annotations

import torch


def tone_map(hdr: torch.Tensor, enable, exposure) -> torch.Tensor:
    mapped = 1.0 - torch.exp(-hdr * exposure)
    return torch.where(enable != 0, mapped, hdr)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    lin = torch.clamp(linear, 0.0, 1.0)
    return torch.where(lin <= 0.0031308, lin * 12.92,
                       1.055 * torch.pow(lin, 1.0 / 2.4) - 0.055)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
