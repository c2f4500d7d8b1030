"""Wavefront OBJ + MTL importer (a copy of the JAX package's
``assets/obj.py``).

Replaces the reference's Assimp-based gizmo.obj import (main.cpp:216-283):
triangulates polygons (fan, like aiProcess_Triangulate), splits sub-meshes by
``usemtl``, and bakes each sub-mesh's MTL diffuse color (``Kd``) into
per-vertex colors — the reference reads the "diffuse" material property per
mesh (main.cpp:243-259) to build its flat-colored ``GizmoVertex`` stream.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from bibim_tpu_torch.assets.mesh import make_mesh
from bibim_tpu_torch.scene.meshgen import Mesh
from bibim_tpu_torch.utils.log import log_warning


def _parse_mtl(path: Path) -> dict[str, dict]:
    materials: dict[str, dict] = {}
    current: dict | None = None
    if not path.is_file():
        log_warning("MTL file not found: {}", path)
        return materials
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "newmtl":
            current = {}
            materials[parts[1]] = current
        elif current is not None and parts[0] in ("Kd", "Ka", "Ks"):
            current[parts[0]] = tuple(float(x) for x in parts[1:4])
    return materials


def load_obj(path: str | os.PathLike, bake_diffuse_colors: bool = True) -> Mesh:
    """Load an OBJ file into a single packed :class:`Mesh`.

    Faces are fan-triangulated. Corners with distinct (v, vt, vn) triples
    become distinct vertices. If ``bake_diffuse_colors`` and an MTL sidecar
    exists, each vertex gets its sub-mesh material's Kd as a color.
    """
    path = Path(path)
    positions: list[tuple] = []
    uvs: list[tuple] = []
    normals: list[tuple] = []
    materials: dict[str, dict] = {}
    current_mtl = ""

    # corner key (v, vt, vn, mtl) -> packed vertex index
    vert_cache: dict[tuple, int] = {}
    packed_pos: list[tuple] = []
    packed_uv: list[tuple] = []
    packed_nrm: list[tuple] = []
    packed_col: list[tuple] = []
    tris: list[tuple[int, int, int]] = []

    def corner(token: str) -> int:
        fields = token.split("/")
        vi = int(fields[0])
        ti = int(fields[1]) if len(fields) > 1 and fields[1] else 0
        ni = int(fields[2]) if len(fields) > 2 and fields[2] else 0
        # OBJ indices are 1-based; negatives are relative to the current end.
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(uvs) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
        key = (vi, ti, ni, current_mtl)
        idx = vert_cache.get(key)
        if idx is None:
            idx = len(packed_pos)
            vert_cache[key] = idx
            packed_pos.append(positions[vi])
            packed_uv.append(uvs[ti] if ti >= 0 else (0.0, 0.0))
            packed_nrm.append(normals[ni] if ni >= 0 else (0.0, 0.0, -1.0))
            kd = materials.get(current_mtl, {}).get("Kd", (1.0, 1.0, 1.0))
            packed_col.append(kd)
        return idx

    for raw in path.read_text().splitlines():
        parts = raw.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v":
            positions.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "vt":
            # OBJ UV origin is bottom-left; keep raw values (the reference's
            # Assimp import does not flip for this asset either).
            uvs.append(tuple(float(x) for x in parts[1:3]))
        elif tag == "vn":
            normals.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "mtllib":
            materials = _parse_mtl(path.parent / parts[1])
        elif tag == "usemtl":
            current_mtl = parts[1]
        elif tag == "f":
            ids = [corner(t) for t in parts[1:]]
            for k in range(1, len(ids) - 1):  # fan triangulation
                tris.append((ids[0], ids[k], ids[k + 1]))

    mesh = make_mesh(
        packed_pos,
        np.asarray(tris, np.int32),
        uvs=packed_uv,
        normals=packed_nrm,
        colors=packed_col if bake_diffuse_colors else None,
        name=path.stem,
    )
    return mesh
