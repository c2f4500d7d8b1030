"""The light pass's raster (K1 on the shadow map's grid,
``csrc/raster.cu``), counted as ``k1.py`` counts a pass, on the
reference's light pass (``passes["shadow"]``: every triangle of the
scene, balls and plane, from the light): each candidate tested at every
texel of its box, each covered texel resolved. Bytes: the candidates'
coverage floats, the records a winner's depth needs (barycentrics and
id, z and w planes: 16 floats), the id plane at every texel, and the
depth key and depth planes at each covered texel.
"""

from __future__ import annotations

from h100_bench.roofline.k1 import pass_count

RECORD_CHANNELS = 16
OUT_PLANES = 3  # id, depth key, depth


def count(passes: dict, frame: dict) -> tuple:
    """Bytes and operations of one frame's light-pass raster."""
    return pass_count(passes["shadow"], RECORD_CHANNELS, OUT_PLANES)
