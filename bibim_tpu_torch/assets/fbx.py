"""Binary FBX mesh importer (a copy of the JAX package's
``assets/fbx.py``; parsed meshes go through the port's on-disk cache,
``assets/asset_cache.py``).

Replaces the reference's Assimp FBX path (scene.cpp:57-82:
``ReadFile(..., aiProcess_Triangulate | aiProcess_CalcTangentSpace)`` followed
by a de-indexing loop). Parses the public "Kaydara FBX Binary" container
(version 7xxx): length-prefixed node records with typed properties, arrays
optionally zlib-deflated. Only geometry is needed — control points, polygon
indices, normal/UV layers — then fan-triangulation and tangent-space
generation reproduce the two Assimp post-process steps.

Raw control-point coordinates are returned unscaled (centimeter/Z-up as
stored); the reference likewise reads ``mMeshes[0]`` vertices directly and
applies ``rotateX(-90) * scale(0.01)`` in the scene (scene.cpp:180-184).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from bibim_tpu_torch.assets.tangents import compute_corner_tangents
from bibim_tpu_torch.scene.meshgen import Mesh
from bibim_tpu_torch.utils.log import bb_assert

_MAGIC = b"Kaydara FBX Binary  \x00"

_SCALAR_FMT = {b"Y": "<h", b"C": "<b", b"I": "<i", b"F": "<f", b"D": "<d", b"L": "<q"}
_ARRAY_DTYPE = {
    b"f": np.dtype("<f4"),
    b"d": np.dtype("<f8"),
    b"l": np.dtype("<i8"),
    b"i": np.dtype("<i4"),
    b"b": np.dtype("<i1"),
}


@dataclass
class FbxNode:
    name: str
    properties: list
    children: list = field(default_factory=list)

    def find(self, name: str) -> "FbxNode | None":
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> list["FbxNode"]:
        return [c for c in self.children if c.name == name]

    def prop(self, index: int = 0, default=None):
        return self.properties[index] if index < len(self.properties) else default


def _read_property(buf: memoryview, pos: int):
    code = bytes(buf[pos : pos + 1])
    pos += 1
    if code in _SCALAR_FMT:
        fmt = _SCALAR_FMT[code]
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, buf, pos)
        return (bool(val) if code == b"C" else val), pos + size
    if code in _ARRAY_DTYPE:
        length, encoding, comp_len = struct.unpack_from("<III", buf, pos)
        pos += 12
        dtype = _ARRAY_DTYPE[code]
        if encoding == 0:
            nbytes = length * dtype.itemsize
            arr = np.frombuffer(buf, dtype=dtype, count=length, offset=pos)
            pos += nbytes
        else:
            raw = zlib.decompress(bytes(buf[pos : pos + comp_len]))
            arr = np.frombuffer(raw, dtype=dtype, count=length)
            pos += comp_len
        return arr, pos
    if code == b"S" or code == b"R":
        (length,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        data = bytes(buf[pos : pos + length])
        pos += length
        return (data.decode("utf-8", "replace") if code == b"S" else data), pos
    raise ValueError(f"unknown FBX property type {code!r} at offset {pos}")


def _read_node(buf: memoryview, pos: int, long_offsets: bool):
    """Read one node record; returns (node_or_None, next_pos)."""
    if long_offsets:
        end, num_props, _prop_len = struct.unpack_from("<QQQ", buf, pos)
        name_len_pos = pos + 24
    else:
        end, num_props, _prop_len = struct.unpack_from("<III", buf, pos)
        name_len_pos = pos + 12
    if end == 0:  # NULL sentinel record
        return None, name_len_pos + 1 + 0  # caller handles via end==0 check below
    name_len = buf[name_len_pos]
    pos = name_len_pos + 1
    name = bytes(buf[pos : pos + name_len]).decode("ascii", "replace")
    pos += name_len
    props = []
    for _ in range(num_props):
        val, pos = _read_property(buf, pos)
        props.append(val)
    node = FbxNode(name=name, properties=props)
    sentinel = 25 if long_offsets else 13
    while pos < end:
        if end - pos == sentinel and all(b == 0 for b in buf[pos:end]):
            pos = end
            break
        child, pos = _read_node(buf, pos, long_offsets)
        if child is None:
            break
        node.children.append(child)
    return node, end


def parse_fbx(path: str | os.PathLike) -> tuple[FbxNode, int]:
    """Parse a binary FBX file into a node tree. Returns (root, version)."""
    data = Path(path).read_bytes()
    bb_assert(data[: len(_MAGIC)] == _MAGIC, f"{path} is not binary FBX")
    (version,) = struct.unpack_from("<I", data, 23)
    long_offsets = version >= 7500
    buf = memoryview(data)
    root = FbxNode(name="", properties=[])
    pos = 27
    sentinel = 25 if long_offsets else 13
    size = len(data)
    while pos + sentinel <= size:
        if long_offsets:
            (end,) = struct.unpack_from("<Q", buf, pos)
        else:
            (end,) = struct.unpack_from("<I", buf, pos)
        if end == 0:
            break
        node, pos = _read_node(buf, pos, long_offsets)
        if node is not None:
            root.children.append(node)
    return root, version


def _layer_lookup(layer: FbxNode, data_name: str, index_name: str, num_corners: int,
                  poly_vertex_index: np.ndarray, width: int) -> np.ndarray:
    """Resolve a LayerElement to per-corner values.

    Handles MappingInformationType ByPolygonVertex/ByControlPoint ×
    ReferenceInformationType Direct/IndexToDirect.
    """
    mapping_node = layer.find("MappingInformationType")
    ref_node = layer.find("ReferenceInformationType")
    mapping = mapping_node.prop() if mapping_node else "ByPolygonVertex"
    ref = ref_node.prop() if ref_node else "Direct"
    data = np.asarray(layer.find(data_name).prop(), np.float64).reshape(-1, width)

    if ref == "IndexToDirect" and layer.find(index_name) is not None:
        idx = np.asarray(layer.find(index_name).prop(), np.int64)
        data = data[idx]

    if mapping == "ByPolygonVertex":
        bb_assert(data.shape[0] == num_corners, f"{data_name}: bad per-corner count")
        return data
    if mapping == "ByControlPoint":
        return data[poly_vertex_index]
    raise ValueError(f"unsupported FBX mapping {mapping} for {data_name}")


def load_fbx_mesh(path: str | os.PathLike, mesh_index: int = 0) -> Mesh:
    """Load one geometry from a binary FBX as a de-indexed triangle mesh
    (disk-cached).

    Mirrors the reference pipeline: triangulate (fan, matching Assimp on
    convex polygons), generate per-corner tangents from UV derivatives
    (aiProcess_CalcTangentSpace analog), and emit one vertex per triangle
    corner (scene.cpp:63-79 de-index loop).
    """
    from bibim_tpu_torch.assets.asset_cache import cached

    return cached(f"torch-fbx{mesh_index}", [path],
                  lambda: _load_fbx_mesh_uncached(path, mesh_index))


def _load_fbx_mesh_uncached(path: str | os.PathLike,
                            mesh_index: int = 0) -> Mesh:
    root, _version = parse_fbx(path)
    objects = root.find("Objects")
    bb_assert(objects is not None, "FBX has no Objects node")
    geoms = [g for g in objects.find_all("Geometry") if g.find("Vertices") is not None]
    bb_assert(len(geoms) > mesh_index, f"FBX has no geometry #{mesh_index}")
    geom = geoms[mesh_index]

    control_points = np.asarray(geom.find("Vertices").prop(), np.float64).reshape(-1, 3)
    pvi = np.asarray(geom.find("PolygonVertexIndex").prop(), np.int64)

    # Decode polygons: negative entry marks last corner of a polygon, value ~x.
    corner_cp = np.where(pvi < 0, ~pvi, pvi)  # control-point id per corner
    poly_ends = np.nonzero(pvi < 0)[0]
    poly_starts = np.concatenate([[0], poly_ends[:-1] + 1])

    # Fan-triangulate: for each polygon of n corners emit (c0, c_k, c_k+1).
    tri_corner_ids = []  # indices into the corner stream
    for s, e in zip(poly_starts, poly_ends):
        for k in range(s + 1, e):
            tri_corner_ids.append((s, k, k + 1))
    tri_corner_ids = np.asarray(tri_corner_ids, np.int64)  # (T,3) corner indices

    num_corners = corner_cp.shape[0]
    normal_layer = geom.find("LayerElementNormal")
    uv_layer = geom.find("LayerElementUV")

    normals_c = (
        _layer_lookup(normal_layer, "Normals", "NormalsIndex", num_corners, corner_cp, 3)
        if normal_layer is not None
        else None
    )
    uvs_c = (
        _layer_lookup(uv_layer, "UV", "UVIndex", num_corners, corner_cp, 2)
        if uv_layer is not None
        else None
    )

    # De-index: one vertex per triangle corner.
    flat = tri_corner_ids.reshape(-1)
    positions = control_points[corner_cp[flat]].astype(np.float32)
    normals = (
        normals_c[flat].astype(np.float32)
        if normals_c is not None
        else np.tile(np.float32([0, 0, -1]), (flat.size, 1))
    )
    uvs = (
        uvs_c[flat].astype(np.float32)
        if uvs_c is not None
        else np.zeros((flat.size, 2), np.float32)
    )
    indices = np.arange(flat.size, dtype=np.int32).reshape(-1, 3)

    tangent_layer = geom.find("LayerElementTangent")
    if tangent_layer is not None:
        tangents = _layer_lookup(
            tangent_layer, "Tangents", "TangentsIndex", num_corners, corner_cp, 3
        )[flat].astype(np.float32)
    else:
        tangents = compute_corner_tangents(positions, uvs, normals, indices)

    return Mesh(
        positions=positions,
        uvs=uvs,
        normals=normals,
        tangents=tangents,
        indices=indices,
        name=Path(path).stem,
    )
