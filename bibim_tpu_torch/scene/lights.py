"""Light data model (port of ``bibim_tpu.scene.lights``).

Struct-of-arrays over L lights: pos, type (0 point, 1 spot, 2 directional),
dir, intensity, color, inner/outer cutoff (radians compared against a
cosine — the reference's quirk, kept).
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import numpy as np
import torch

from bibim_tpu_torch.utils import profiling

MAX_NUM_LIGHTS = 100


class LightType(IntEnum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2


class Lights(NamedTuple):
    """All fields are (L, ...) tensors: float32, ``type`` int32."""

    pos: torch.Tensor  # (L,3)
    type: torch.Tensor  # (L,)
    dir: torch.Tensor  # (L,3)
    intensity: torch.Tensor  # (L,)
    color: torch.Tensor  # (L,3)
    inner_cutoff: torch.Tensor  # (L,)
    outer_cutoff: torch.Tensor  # (L,)

    @property
    def num_lights(self) -> int:
        return int(self.pos.shape[0])


def make_lights(entries: list[dict], device="cuda") -> Lights:
    """Lights from dicts keyed like the Light struct; missing fields are 0."""
    n = len(entries)

    def col(key, width):
        out = np.zeros((n, width) if width > 1 else (n,), np.float32)
        for i, e in enumerate(entries):
            if key in e:
                out[i] = np.asarray(e[key], np.float32)
        return torch.as_tensor(out, device=device)

    types = np.asarray([int(e.get("type", LightType.POINT)) for e in entries],
                       np.int32)
    return Lights(
        pos=col("pos", 3),
        type=torch.as_tensor(types, device=device),
        dir=col("dir", 3),
        intensity=col("intensity", 1),
        color=col("color", 3),
        inner_cutoff=col("inner_cutoff", 1),
        outer_cutoff=col("outer_cutoff", 1),
    )


# Per-light parameter row consumed by the shading kernels (K2, K5):
# px py pz | type | dx dy dz | intensity | cr cg cb | inner | outer |
# vis_flag | 0 0
LIGHT_ROW = 16


def pack_lights(lights: Lights, vis_light: int = -1) -> torch.Tensor:
    """(L, 16) float32 rows, on the lights' device (no host round trip);
    light ``vis_light`` carries the visibility flag (the shadow-casting
    light, whose radiance the kernels scale by a visibility plane)."""
    n = lights.num_lights
    dev = lights.pos.device
    if n == 0:
        return torch.zeros((1, LIGHT_ROW), dtype=torch.float32, device=dev)
    flag = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if 0 <= vis_light < n:
        # The scalar reaches the card by a synchronous pageable copy
        # (counted; see test_host_syncs_count_every_sync).
        flag[vis_light, 0] = 1.0
        if dev.type == "cuda":
            profiling.count("host_syncs")
    return torch.cat([
        lights.pos,
        lights.type.to(torch.float32)[:, None],
        lights.dir,
        lights.intensity[:, None],
        lights.color,
        lights.inner_cutoff[:, None],
        lights.outer_cutoff[:, None],
        flag,
    ], dim=1).contiguous()
