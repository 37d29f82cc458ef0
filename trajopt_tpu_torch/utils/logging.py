"""Leveled logging (trajopt_common/logging.hpp analog: FATAL..TRACE with a
global threshold settable via TRAJOPT_LOG_THRESH).

A copy of ``trajopt_tpu/utils/logging.py`` with the port's logger name."""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "FATAL": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARN": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "TRACE": TRACE,
}


def get_logger(name: str = "trajopt_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
        logger.addHandler(h)
        thresh = os.environ.get("TRAJOPT_LOG_THRESH", "INFO").upper()
        logger.setLevel(_LEVELS.get(thresh, logging.INFO))
    return logger


def set_log_level(level: str) -> None:
    get_logger().setLevel(_LEVELS[level.upper()])
