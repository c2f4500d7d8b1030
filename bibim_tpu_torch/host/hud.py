"""In-frame HUD text overlay (the port's copy of ``bibim_tpu.host.hud``).

The reference renders its debug GUI into the frame as the last overlay
stage (ImGui draw data recorded in subpass 4 of the reference's
main.cpp). The visual capability, stats burned into the output pixels,
is reproduced with a 5×7 bitmap font drawn through the same compact
overlay composite (K4) as the light spheres:

- The glyph grid is static geometry: ``max_chars × 35`` screen-space cells
  (one per font pixel), two triangles each, built once per frame size.
- Per frame only a (cells,) float mask changes: 1 lights a cell, 0
  collapses its quad to a point (degenerate, culled by triangle setup).
- Cells draw at reversed-Z depth 1.0 against a cleared depth plane, so the
  HUD composites over everything, like an ImGui draw after the scene.

Everything here is numpy; ``render_frame(..., hud=(geometry, mask))``
moves it to the frame's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# 5×7 font: 7 rows of 5-bit patterns (MSB = leftmost column).
_F = {
    "0": "0E 11 13 15 19 11 0E", "1": "04 0C 04 04 04 04 0E",
    "2": "0E 11 01 02 04 08 1F", "3": "1F 02 04 02 01 11 0E",
    "4": "02 06 0A 12 1F 02 02", "5": "1F 10 1E 01 01 11 0E",
    "6": "06 08 10 1E 11 11 0E", "7": "1F 01 02 04 08 08 08",
    "8": "0E 11 11 0E 11 11 0E", "9": "0E 11 11 0F 01 02 0C",
    "A": "0E 11 11 1F 11 11 11", "B": "1E 11 11 1E 11 11 1E",
    "C": "0E 11 10 10 10 11 0E", "D": "1C 12 11 11 11 12 1C",
    "E": "1F 10 10 1E 10 10 1F", "F": "1F 10 10 1E 10 10 10",
    "G": "0E 11 10 17 11 11 0F", "H": "11 11 11 1F 11 11 11",
    "I": "0E 04 04 04 04 04 0E", "J": "07 02 02 02 02 12 0C",
    "K": "11 12 14 18 14 12 11", "L": "10 10 10 10 10 10 1F",
    "M": "11 1B 15 15 11 11 11", "N": "11 19 15 13 11 11 11",
    "O": "0E 11 11 11 11 11 0E", "P": "1E 11 11 1E 10 10 10",
    "Q": "0E 11 11 11 15 12 0D", "R": "1E 11 11 1E 14 12 11",
    "S": "0F 10 10 0E 01 01 1E", "T": "1F 04 04 04 04 04 04",
    "U": "11 11 11 11 11 11 0E", "V": "11 11 11 11 11 0A 04",
    "W": "11 11 11 15 15 1B 11", "X": "11 11 0A 04 0A 11 11",
    "Y": "11 11 0A 04 04 04 04", "Z": "1F 01 02 04 08 10 1F",
    ".": "00 00 00 00 00 0C 0C", "-": "00 00 00 1F 00 00 00",
    ":": "00 0C 0C 00 0C 0C 00", "/": "01 01 02 04 08 10 10",
    "+": "00 04 04 1F 04 04 00", "%": "19 1A 02 04 08 0B 13",
    " ": "00 00 00 00 00 00 00",
}
FONT = {
    ch: np.array(
        [[(int(row, 16) >> (4 - c)) & 1 for c in range(5)]
         for row in rows.split()],
        np.float32,
    )
    for ch, rows in _F.items()
}
GLYPH_H, GLYPH_W = 7, 5
CELLS_PER_CHAR = GLYPH_H * GLYPH_W
ADVANCE = 6  # glyph columns + 1 spacing


class HudGeometry(NamedTuple):
    """Static clip-space cell centers + half extents for a text line."""

    cx: np.ndarray  # (cells,) f32 clip x of each cell center (w = 1)
    cy: np.ndarray  # (cells,)
    dx: float  # cell half extent, clip units
    dy: float
    max_chars: int


def build_hud_geometry(width: int, height: int, max_chars: int = 48,
                       origin=(6, 6), scale: int = 2) -> HudGeometry:
    """Cell grid for one text line at pixel ``origin`` (top-left), each
    font pixel ``scale``×``scale`` framebuffer pixels."""
    ox, oy = origin
    xs = np.empty(max_chars * CELLS_PER_CHAR, np.float32)
    ys = np.empty_like(xs)
    i = 0
    for s in range(max_chars):
        for r in range(GLYPH_H):
            for c in range(GLYPH_W):
                px = ox + (s * ADVANCE + c) * scale + scale * 0.5
                py = oy + r * scale + scale * 0.5
                xs[i] = 2.0 * px / width - 1.0
                ys[i] = 2.0 * py / height - 1.0
                i += 1
    return HudGeometry(
        cx=xs, cy=ys,
        dx=float(scale) / width,  # scale px → 2*scale/(2*width) clip
        dy=float(scale) / height,
        max_chars=max_chars,
    )


def hud_text_mask(text: str, max_chars: int) -> np.ndarray:
    """(max_chars*35,) float mask lighting the cells of ``text``
    (uppercased; unknown glyphs render as space)."""
    mask = np.zeros((max_chars, GLYPH_H, GLYPH_W), np.float32)
    for s, ch in enumerate(text.upper()[:max_chars]):
        mask[s] = FONT.get(ch, FONT[" "])
    return mask.reshape(-1)
