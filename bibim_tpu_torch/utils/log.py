"""Logging and assertion helpers the asset loaders use (a copy of the JAX
package's ``utils/log.py`` helpers; the logger is the port's own)."""

from __future__ import annotations

import logging
import os

_logger = logging.getLogger("bibim_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(os.environ.get("BIBIM_LOG", "INFO").upper())


def log_info(fmt: str, *args, **kwargs) -> None:
    _logger.info(fmt.format(*args, **kwargs) if (args or kwargs) else fmt)


def log_warning(fmt: str, *args, **kwargs) -> None:
    _logger.warning(fmt.format(*args, **kwargs) if (args or kwargs) else fmt)


def bb_assert(condition, message: str = "assertion failed") -> None:
    """Host-side invariant check (BB_ASSERT)."""
    if not condition:
        raise AssertionError(message)
