"""Logging for the port: memoized stdout loggers (the JAX package's
``logging_utils.get_logger``)."""

from __future__ import annotations

import logging
import sys
from typing import Dict

_loggers: Dict[str, logging.Logger] = {}


def get_logger(name: str, level=logging.INFO) -> logging.Logger:
    """Memoized stdout logger with the thread-name format."""
    if name not in _loggers:
        logger = logging.getLogger(name)
        logger.setLevel(level)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s [%(threadName)s] %(levelname)s %(name)s - %(message)s"
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
        _loggers[name] = logger
    return _loggers[name]
