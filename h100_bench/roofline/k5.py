"""K5, the G-buffer shade (``csrc/gbuffer_shade.cu``): from the sampled
G-buffer planes to tone-mapped LDR planes, on the deferred frames that
sample through K6 / K7 (those with IBL).

Bytes, at each covered pixel of the main pass: the G-buffer planes K5
reads (world position, normal, albedo, metallic, roughness, ao: 12
floats), the visibility plane of the shadow-casting light where the frame
has a light pass, the 3 IBL ambient planes, and the 3 LDR planes it
writes; and the lights (16 floats each). Operations: per covered pixel
the GGX loop, ``LIGHT_OPS`` a light, as ``k2.py`` counts it.
"""

from __future__ import annotations

from h100_bench.roofline.k2 import LIGHT_FLOATS, LIGHT_OPS

GBUFFER_PLANES = 12
AMBIENT_PLANES = 3
LDR_PLANES = 3


def count(passes: dict, frame: dict) -> tuple:
    """Bytes and operations of one frame's K5; ``frame["lights"]`` the
    light count."""
    lights = frame["lights"]
    covered = int((passes["main"]["tri"] >= 0).sum())
    planes = (GBUFFER_PLANES + ("shadow" in passes) + AMBIENT_PLANES
              + LDR_PLANES)
    nbytes = covered * planes * 4 + lights * LIGHT_FLOATS * 4
    return nbytes, covered * lights * LIGHT_OPS
