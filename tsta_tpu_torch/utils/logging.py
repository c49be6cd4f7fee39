"""Structured logging.

The reference logs via bare printf/stderr (SURVEY.md section 5).  Here a
thin stdlib wrapper with an optional JSON mode for machine consumption.

The port's own copy of ``tsta_tpu/utils/logging.py``, so that the port
imports nothing of the JAX package; the tests hold the two against each
other.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "tsta") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("TSTA_LOG_LEVEL", "INFO"))
    return logger


def emit_json(record: dict, stream=None) -> None:
    """One machine-readable result line (CLI --json mode)."""
    print(json.dumps(record), file=stream or sys.stdout)
