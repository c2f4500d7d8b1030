"""Concurrent image loader (a copy of ``bibim_tpu.assets.loader``).

The reference decodes PNGs on Win32 threads in batches of up to 64
(ImageLoader, resource.cpp:157-267) and then serializes the GPU uploads.
Here decode fans out on a thread pool (PIL releases the GIL for decode
work); a file PIL cannot read goes to the native decoder
(``bibim_tpu_torch.native``) where its library loads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from bibim_tpu_torch.assets.image import load_image_rgba8
from bibim_tpu_torch.utils.log import log_warning

_MAX_CONCURRENT = 64  # MAXIMUM_WAIT_OBJECTS batch width (resource.cpp:241-267)


def _decode_one(path: Path) -> np.ndarray | None:
    try:
        return load_image_rgba8(path)
    except Exception as exc:  # missing/corrupt file tolerated (resource.cpp:161-163)
        from bibim_tpu_torch.native import decode_image_rgba8

        img = decode_image_rgba8(str(path)) if path.is_file() else None
        if img is None:
            log_warning("image load failed for {}: {}", path, exc)
        return img


@dataclass
class ImageLoader:
    """Task-queue image loader (enqueueImageLoadTask /
    finalizeAllImageLoads, resource.h:30-38)."""

    _tasks: list = field(default_factory=list)

    def enqueue_image_load_task(self, path: str | os.PathLike, sink) -> None:
        """Queue a decode; ``sink(np.ndarray | None)`` receives the result."""
        self._tasks.append((Path(path), sink))

    def finalize_all_image_loads(self) -> None:
        """Decode every queued image concurrently, then deliver serially
        in enqueue order (the reference's threaded-decode /
        serial-finalize split)."""
        if not self._tasks:
            return
        tasks, self._tasks = self._tasks, []
        with ThreadPoolExecutor(
                max_workers=min(_MAX_CONCURRENT, len(tasks))) as pool:
            results = list(pool.map(_decode_one, [p for p, _ in tasks]))
        for (_, sink), img in zip(tasks, results):
            sink(img)
