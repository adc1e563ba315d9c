"""The package's logger: the port's own copy of ``get_logger`` from
``dlti_tpu/utils/logging.py`` (one process, so no rank gating)."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "dlti_tpu_torch") -> logging.Logger:
    """A logger writing ``time level name: message`` lines to stdout."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
