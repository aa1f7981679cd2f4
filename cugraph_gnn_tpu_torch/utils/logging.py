"""Leveled logging for the port's examples.

Counterpart of ``cugraph_gnn_tpu/utils/logging.py``: the levels fatal to
trace (``trace`` below DEBUG), settable once at start-up.  The logger is
``cugraph_gnn_tpu_torch``, not the JAX package's, so that the two packages
never share handlers or levels.
"""

from __future__ import annotations

import logging
import sys

LEVELS = {
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG - 5,
}

logging.addLevelName(LEVELS["trace"], "TRACE")

_logger = logging.getLogger("cugraph_gnn_tpu_torch")


def set_log_level(level: str = "info"):
    """Set the package logger's level (a key of ``LEVELS``, any case) and
    give it a stderr handler if it has none."""
    _logger.setLevel(LEVELS[level.lower()])
    if not _logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(levelname)s][%(asctime)s] %(message)s", "%H:%M:%S"))
        _logger.addHandler(h)


def get_logger() -> logging.Logger:
    """The package logger, at level info with a stderr handler if nothing
    set it up yet."""
    if not _logger.handlers:
        set_log_level("info")
    return _logger
