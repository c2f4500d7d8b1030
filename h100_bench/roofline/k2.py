"""K2, the sampled shade of the deferred frame (``csrc/shade.cu``): from
the raster's planes to tone-mapped LDR planes.

Bytes: the coverage of every live tile (a tile with a shaded pixel; one
byte a pixel), 8 float planes at each shaded pixel (u, v, world
position, normal), each distinct texel the pixels' bilinear footprints
touch in each sampled map (its channels the shading reads: albedo rgb,
roughness, metallic, ao), the lights (16 floats each), and 3 float LDR
planes of every live tile written once. Operations: per shaded pixel the
GGX loop (``LIGHT_OPS`` a light) and 4 taps of each of 6 channels
(``SAMPLE_TAP_OPS`` each). Counted from ``chip_smoke.shade_bound``,
recast on the frame's quantities.
"""

from __future__ import annotations

import torch

# The frame's tile (its settings' tile_h × tile_w): K2 shades live tiles.
TILE_H, TILE_W = 8, 128

LIGHT_OPS = 80
SAMPLE_TAP_OPS = 8
IN_PLANES = 8
LIGHT_FLOATS = 16
# Sampled map → channels read.
MAP_CHANNELS = {"albedo": 3, "roughness": 1, "metallic": 1, "ao": 1}


def distinct_texels(u, v, h: int, w: int) -> int:
    """Texels the bilinear REPEAT footprints at (u, v) touch."""
    x0 = torch.remainder(torch.floor(u * w - 0.5).long(), w)
    y0 = torch.remainder(torch.floor(v * h - 0.5).long(), h)
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    ids = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    return int(torch.unique(ids).numel())


def count(passes: dict, frame: dict) -> tuple:
    """Bytes and operations of one frame's shade; ``frame["lights"]``
    the light count, ``frame["map_sizes"]`` sampled map → (height,
    width)."""
    lights, map_sizes = frame["lights"], frame["map_sizes"]
    p = passes["main"]
    w, h = p["width"], p["height"]
    valid = p["tri"] >= 0
    nv = int(valid.sum())
    tiles_x, tiles_y = -(-w // TILE_W), -(-h // TILE_H)
    pad = torch.zeros((tiles_y * TILE_H, tiles_x * TILE_W), dtype=torch.bool,
                      device=valid.device)
    pad[:h, :w] = valid.reshape(h, w)
    live_px = int(pad.reshape(tiles_y, TILE_H, tiles_x, TILE_W).any(3)
                  .any(1).sum()) * TILE_H * TILE_W
    u, v = p["u"][valid], p["v"][valid]
    texels = sum(distinct_texels(u, v, *map_sizes[k]) * ch
                 for k, ch in MAP_CHANNELS.items())
    nbytes = (live_px + nv * IN_PLANES * 4 + texels + lights * LIGHT_FLOATS * 4
              + live_px * 3 * 4)
    taps = 4 * sum(MAP_CHANNELS.values())
    ops = nv * (lights * LIGHT_OPS + taps * SAMPLE_TAP_OPS)
    return nbytes, ops
