"""The stand-in resource root: ``config.toml``, the ``pbr/`` maps, the ball
as a binary ``ShaderBall.fbx`` and ``gizmo.obj``, written from a seed.

Copied from ``chip_smoke.py`` (``write_standin_resources``,
``gizmo_standin``, ``write_fbx_mesh``) so that later changes to the smoke
run do not move the benchmark; seeded here, and without the cube scene's
images, which no cell reads.
"""

from __future__ import annotations

import json
import shutil
import struct
from pathlib import Path

import numpy as np
from PIL import Image

from h100_bench.standin.meshgen import (
    Mesh,
    generate_cube_mesh,
    generate_uv_sphere_mesh,
)

# The ball: radius 100 in model units (the FBX's centimetres), 100 × 51
# divisions, 2·100·50 = 10,000 triangles (the real ShaderBall.fbx: 9,776).
BALL_SPHERE = (100.0, 100, 51)
MATERIALS = ("standin_a", "standin_b")
# (map, channels) of the default material's 16² maps and of each
# stand-in material's big maps (metallic, ao and height fall back to the
# default's).
DEFAULT_MAPS = (("albedo", 3), ("metallic", 1), ("roughness", 1), ("ao", 1),
                ("normal", 3), ("height", 1))
MATERIAL_MAPS = (("albedo", 3), ("normal", 3), ("roughness", 1))
STAMP = "standin.json"


def ball_mesh() -> Mesh:
    """The stand-in ShaderBall mesh (indexed, model units)."""
    return generate_uv_sphere_mesh(*BALL_SPHERE)


def gizmo_mesh() -> Mesh:
    """A coloured stand-in for gizmo.obj: three bars along the axes (red
    x, green y, blue z) from a grey ball, turned so that the camera sees
    all three, 360 triangles (gizmo.obj has 363)."""
    parts = [(generate_uv_sphere_mesh(1.5, 18, 10), np.eye(3), np.zeros(3),
              (0.6, 0.6, 0.6))]
    for axis, color in enumerate(((1, 0.2, 0.2), (0.2, 1, 0.2),
                                  (0.2, 0.2, 1))):
        scale = np.full(3, 0.6)
        scale[axis] = 6.0
        shift = np.zeros(3)
        shift[axis] = 3.0
        parts.append((generate_cube_mesh(1.0), np.diag(scale), shift, color))
    a, b = np.radians(25.0), np.radians(35.0)
    rot = (np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]])
           @ np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]]))
    pos, nrm, uvs, tan, col, idx = [], [], [], [], [], []
    base = 0
    for mesh, scale, shift, color in parts:
        pos.append((mesh.positions @ scale + shift) @ rot.T)
        nrm.append(mesh.normals @ rot.T)
        tan.append(mesh.tangents @ rot.T)
        uvs.append(mesh.uvs)
        col.append(np.tile(np.float32(color), (len(mesh.positions), 1)))
        idx.append(mesh.indices + base)
        base += len(mesh.positions)
    f32 = np.float32
    return Mesh(positions=np.concatenate(pos).astype(f32),
                uvs=np.concatenate(uvs).astype(f32),
                normals=np.concatenate(nrm).astype(f32),
                tangents=np.concatenate(tan).astype(f32),
                indices=np.concatenate(idx).astype(np.int32),
                colors=np.concatenate(col).astype(f32))


def _fbx_node(pos: int, name: str, props=(), children=()) -> bytes:
    """One node record of a binary FBX 7.4 file (32-bit offsets) at file
    offset ``pos``; ``children`` are (name, props, children) tuples. A
    node with children ends with the 13-byte null record."""
    body = b""
    for p in props:
        if isinstance(p, str):
            data = p.encode()
            body += b"S" + struct.pack("<I", len(data)) + data
        elif isinstance(p, np.ndarray):
            code = {np.dtype("<f8"): b"d", np.dtype("<i4"): b"i"}[p.dtype]
            data = np.ascontiguousarray(p).tobytes()
            body += code + struct.pack("<III", p.size, 0, len(data)) + data
        else:
            body += b"L" + struct.pack("<q", int(p))
    end = pos + 13 + len(name) + len(body)
    nested = b""
    for child in children:
        rec = _fbx_node(end, *child)
        nested += rec
        end += len(rec)
    if children:
        nested += b"\0" * 13
        end += 13
    return (struct.pack("<III", end, len(props), len(body))
            + struct.pack("<B", len(name)) + name.encode() + body + nested)


def write_fbx_mesh(path, mesh: Mesh) -> int:
    """``mesh`` as a minimal binary FBX 7.4 file: one Objects/Geometry
    node with ``Vertices`` (the shared positions), ``PolygonVertexIndex``
    (one polygon a triangle, its last corner bit-inverted), normals by
    polygon vertex (Direct) and uvs by polygon vertex through ``UVIndex``
    (IndexToDirect); uncompressed arrays. Returns the triangle count."""
    idx = np.asarray(mesh.indices, np.int64)
    pvi = idx.astype(np.int32).copy()
    pvi[:, 2] = ~pvi[:, 2]
    flat = idx.reshape(-1)

    def f64(a):
        return np.asarray(a, np.float32).astype("<f8").reshape(-1)

    geometry = ("Geometry", (1000, "Ball\0\x01Geometry", "Mesh"), (
        ("Vertices", (f64(mesh.positions),), ()),
        ("PolygonVertexIndex", (pvi.reshape(-1).astype("<i4"),), ()),
        ("LayerElementNormal", (0,), (
            ("MappingInformationType", ("ByPolygonVertex",), ()),
            ("ReferenceInformationType", ("Direct",), ()),
            ("Normals", (f64(np.asarray(mesh.normals)[flat]),), ()))),
        ("LayerElementUV", (0,), (
            ("MappingInformationType", ("ByPolygonVertex",), ()),
            ("ReferenceInformationType", ("IndexToDirect",), ()),
            ("UV", (f64(mesh.uvs),), ()),
            ("UVIndex", (flat.astype("<i4"),), ())))))
    head = b"Kaydara FBX Binary  \0\x1a\0" + struct.pack("<I", 7400)
    data = head + _fbx_node(len(head), "Objects", (), (geometry,))
    with open(path, "wb") as f:
        f.write(data + b"\0" * 13)
    return len(idx)


def write_gizmo_obj(root: Path, gizmo: Mesh) -> None:
    """``gizmo.obj`` + ``gizmo.mtl``: the parts as MTL materials (Kd the
    part's colour, which the OBJ loader bakes per vertex); coordinates
    printed as the repr of each float32, so they read back exactly."""
    colors = sorted({tuple(c) for c in gizmo.colors.tolist()})
    (root / "gizmo.mtl").write_text("".join(
        f"newmtl c{k}\nKd {c[0]!r} {c[1]!r} {c[2]!r}\n"
        for k, c in enumerate(colors)))
    lines = ["mtllib gizmo.mtl"]
    lines += [f"v {p[0]!r} {p[1]!r} {p[2]!r}"
              for p in gizmo.positions.tolist()]
    lines += [f"vn {q[0]!r} {q[1]!r} {q[2]!r}"
              for q in gizmo.normals.tolist()]
    current = None
    for tri in gizmo.indices.tolist():
        k = colors.index(tuple(gizmo.colors[tri[0]].tolist()))
        if k != current:
            lines.append(f"usemtl c{k}")
            current = k
        lines.append("f " + " ".join(f"{i + 1}//{i + 1}" for i in tri))
    (root / "gizmo.obj").write_text("\n".join(lines) + "\n")


def write_resources(root, seed: int, map_size: int = 2048) -> Path:
    """A resource root under ``root``: ``config.toml`` (its
    ``common_root`` is ``root``); ``pbr/default`` with 16² maps of all six
    kinds and two materials (:data:`MATERIALS`) with seeded
    ``map_size``² albedo / normal / roughness PNGs (at 2048² the big maps
    bind as one block table, as the real ones do); ``gizmo.obj``
    (:func:`gizmo_mesh`); ``ShaderBall.fbx`` (:func:`ball_mesh`).
    Returns the config path."""
    root = Path(root).resolve()
    rng = np.random.default_rng(seed)

    def image(path, n, channels):
        path.parent.mkdir(parents=True, exist_ok=True)
        px = rng.integers(0, 256, (n, n, channels), dtype=np.uint8)
        Image.fromarray(px[:, :, 0] if channels == 1 else px).save(
            path, compress_level=0)

    for kind, ch in DEFAULT_MAPS:
        image(root / "pbr" / "default" / f"{kind}.png", 16, ch)
    for name in MATERIALS:
        for kind, ch in MATERIAL_MAPS:
            image(root / "pbr" / name / f"{kind}.png", map_size, ch)
    write_gizmo_obj(root, gizmo_mesh())
    write_fbx_mesh(root / "ShaderBall.fbx", ball_mesh())
    config = root / "config.toml"
    config.write_text(f'[resource_path]\ncommon_root = "{root}"\n'
                      f'shader_root = "{root / "shaders"}"\n')
    return config


def prepare(cache_dir, seed: int, map_size: int = 2048) -> tuple:
    """The resource root of ``seed`` in ``cache_dir``: reused when the
    directory already holds this seed's root, else written anew (the
    directory holds one root). Returns (the config path, whether it was
    written anew)."""
    cache_dir = Path(cache_dir)
    stamp = cache_dir / STAMP
    want = {"seed": int(seed), "map_size": int(map_size)}
    if stamp.is_file() and json.loads(stamp.read_text()) == want:
        return (cache_dir / "root" / "config.toml").resolve(), False
    if cache_dir.exists():
        shutil.rmtree(cache_dir)
    cache_dir.mkdir(parents=True)
    config = write_resources(cache_dir / "root", seed, map_size)
    stamp.write_text(json.dumps(want))
    return config, True

