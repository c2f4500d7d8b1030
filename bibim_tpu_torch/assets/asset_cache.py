"""On-disk asset cache (port of ``bibim_tpu.assets.asset_cache``).

Parsed meshes and material sets (decode + mip building take seconds on the
host) are pickled to ``.asset_cache/`` at the repository root, keyed by
the source files' (path, mtime, size). The JAX package caches into the
same directory, so every tag here starts with ``torch-``: a pickle of the
JAX package's types would import ``bibim_tpu`` when loaded, and the two
packages must never read each other's entries.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from pathlib import Path

from bibim_tpu_torch.utils.log import log_info

CACHE_DIR = Path(__file__).resolve().parents[2] / ".asset_cache"
TAG_PREFIX = "torch-"


def _key(tag: str, paths: list[Path]) -> str:
    h = hashlib.sha1(tag.encode())
    for p in sorted(paths):
        st = p.stat()
        h.update(str(p).encode())
        h.update(str(st.st_mtime_ns).encode())
        h.update(str(st.st_size).encode())
    return h.hexdigest()[:24]


def cache_file(tag: str, source_paths: list[os.PathLike]) -> Path:
    """Where :func:`cached` keeps ``tag``'s result for these sources."""
    if not tag.startswith(TAG_PREFIX):
        raise ValueError(f"asset cache tag {tag!r} must start with "
                         f"{TAG_PREFIX!r}")
    paths = [Path(p) for p in source_paths if Path(p).exists()]
    return CACHE_DIR / f"{tag}-{_key(tag, paths)}.pkl"


def cached(tag: str, source_paths: list[os.PathLike], builder):
    """Return builder()'s result, cached on disk keyed by the source
    files (``tag`` starts with ``torch-``)."""
    try:
        path = cache_file(tag, source_paths)
    except OSError:
        return builder()
    if path.is_file():
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:  # noqa: BLE001 - a stale or torn entry rebuilds
            pass
    result = builder()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        tmp.replace(path)
        log_info("asset cache: stored {}", path.name)
    except OSError:
        pass
    return result
