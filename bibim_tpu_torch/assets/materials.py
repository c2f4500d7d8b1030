"""PBR material sets (a copy of the JAX package's ``assets/materials.py``;
maps decode on ``assets/loader.py``'s thread pool, and a set goes through
the port's on-disk cache, ``assets/asset_cache.py``).

``createPBRMaterialSet`` / ``getPBRMapOrDefault`` parity: a material is 6
maps — Albedo, Metallic, Roughness, AO, Normal, Height — found as
``<common_root>/pbr/<name>/<map>.png``; all maps decode concurrently, the
``default`` material is split out, and a missing map falls back per map to
the default material's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import IntEnum
from pathlib import Path

import numpy as np

from bibim_tpu_torch.assets.loader import ImageLoader
from bibim_tpu_torch.utils.config import get_resource_root
from bibim_tpu_torch.utils.log import log_info


class PBRMapType(IntEnum):
    """Map stacking order."""

    ALBEDO = 0
    METALLIC = 1
    ROUGHNESS = 2
    AO = 3
    NORMAL = 4
    HEIGHT = 5


_MAP_FILE_NAMES = {
    PBRMapType.ALBEDO: "albedo.png",
    PBRMapType.METALLIC: "metallic.png",
    PBRMapType.ROUGHNESS: "roughness.png",
    PBRMapType.AO: "ao.png",
    PBRMapType.NORMAL: "normal.png",
    PBRMapType.HEIGHT: "height.png",
}

# Neutral per-map constants used only if even the default material lacks a
# map: albedo white, metallic 0, roughness 1, ao 1, normal +Z, height 0.
_NEUTRAL_TEXELS = {
    PBRMapType.ALBEDO: (255, 255, 255, 255),
    PBRMapType.METALLIC: (0, 0, 0, 255),
    PBRMapType.ROUGHNESS: (255, 255, 255, 255),
    PBRMapType.AO: (255, 255, 255, 255),
    PBRMapType.NORMAL: (128, 128, 255, 255),
    PBRMapType.HEIGHT: (0, 0, 0, 255),
}


@dataclass
class PBRMaterial:
    """One material: name + per-map mip pyramids ((H,W,4) uint8 level 0)."""

    name: str
    maps: dict = field(default_factory=dict)

    def map_or_none(self, map_type: PBRMapType):
        return self.maps.get(map_type)


@dataclass
class PBRMaterialSet:
    materials: list
    default_material: PBRMaterial

    def get_pbr_map_or_default(self, material_index: int,
                               map_type: PBRMapType) -> list:
        """Per-map fallback to the default material."""
        mips = self.materials[material_index].map_or_none(map_type)
        if mips is None:
            mips = self.default_material.map_or_none(map_type)
        if mips is None:
            texel = np.asarray(_NEUTRAL_TEXELS[map_type],
                               np.uint8).reshape(1, 1, 4)
            mips = [texel]
        return mips

    @property
    def names(self) -> list:
        return [m.name for m in self.materials]


def create_pbr_material_set(pbr_root: str | os.PathLike | None = None,
                            with_mips: bool = True) -> PBRMaterialSet:
    """Scan ``<common_root>/pbr/*`` directories and load all maps
    concurrently (directories with no recognized map stay, as all-default
    materials). Disk-cached."""
    from bibim_tpu_torch.assets.asset_cache import cached

    root = (Path(pbr_root) if pbr_root is not None
            else get_resource_root().common("pbr"))
    sources = sorted(root.glob("*/*.png")) if root.is_dir() else []
    return cached(f"torch-pbrset{'m' if with_mips else ''}", sources,
                  lambda: _create_pbr_material_set_uncached(root, with_mips))


def _create_pbr_material_set_uncached(root: Path,
                                      with_mips: bool) -> PBRMaterialSet:
    from bibim_tpu_torch.ops.texture_quad import build_mip_pyramid

    loader = ImageLoader()
    materials = []
    for entry in sorted(root.iterdir()) if root.is_dir() else []:
        if not entry.is_dir():
            continue
        mat = PBRMaterial(name=entry.name, maps={t: None for t in PBRMapType})
        materials.append(mat)
        for map_type, fname in _MAP_FILE_NAMES.items():
            fpath = entry / fname
            if fpath.is_file():

                def sink(img, _mat=mat, _t=map_type):
                    if img is not None:
                        _mat.maps[_t] = (build_mip_pyramid(img) if with_mips
                                         else [img])

                loader.enqueue_image_load_task(fpath, sink)
    loader.finalize_all_image_loads()

    default = next((m for m in materials if m.name == "default"), None)
    if default is not None:
        materials = [m for m in materials if m is not default]
    else:
        default = PBRMaterial(name="default",
                              maps={t: None for t in PBRMapType})
    log_info("PBR material set: {} materials + default ({} maps loaded)",
             len(materials),
             sum(1 for m in [default, *materials] for v in m.maps.values()
                 if v))
    return PBRMaterialSet(materials=materials, default_material=default)
