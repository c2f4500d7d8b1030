"""Resource root (a copy of the JAX package's ``utils/config.py``): reads
``[resource_path] common_root / shader_root`` from the same
``config.toml`` — an explicit path, then ``$BIBIM_CONFIG``, then the one at
the repository root. Without any, the roots default to ``resources/``
beside the repository root's ``config.toml``."""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class ResourceRoot:
    common_root: Path
    shader_root: Path

    def common(self, *relative: str) -> Path:
        return self.common_root.joinpath(*relative)

    def shader(self, *relative: str) -> Path:
        return self.shader_root.joinpath(*relative)


_active_root: ResourceRoot | None = None


def init_resource_root(config_path: str | os.PathLike | None = None
                       ) -> ResourceRoot:
    """Load the resource root config; paths in the file are relative to
    it."""
    global _active_root
    candidates = []
    if config_path is not None:
        candidates.append(Path(config_path))
    if "BIBIM_CONFIG" in os.environ:
        candidates.append(Path(os.environ["BIBIM_CONFIG"]))
    candidates.append(_REPO_ROOT / "config.toml")

    common_root = _REPO_ROOT / "resources"
    shader_root = common_root / "shaders"
    for cand in candidates:
        if cand.is_file():
            with open(cand, "rb") as f:
                data = tomllib.load(f)
            section = data.get("resource_path", {})
            base = cand.parent
            if "common_root" in section:
                common_root = (base / section["common_root"]).resolve()
            if "shader_root" in section:
                shader_root = (base / section["shader_root"]).resolve()
            break

    _active_root = ResourceRoot(common_root=common_root,
                                shader_root=shader_root)
    return _active_root


def get_resource_root() -> ResourceRoot:
    """Active root, initialized from the config on first use."""
    global _active_root
    if _active_root is None:
        _active_root = init_resource_root()
    return _active_root
