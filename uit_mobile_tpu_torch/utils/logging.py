"""Logging: a stdout sink configured at first use (loguru-free)."""

from __future__ import annotations

import logging
import sys

_FMT = "[\x1b[32m%(asctime)s\x1b[0m] %(message)s"
_PLAIN_FMT = "[%(asctime)s] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def get_logger(name: str = "uit_mobile_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    # per-logger setup marker: a module-global flag would leave every logger
    # name after the first without a handler
    if not getattr(logger, "_uit_console_sink", False):
        handler = logging.StreamHandler(sys.stdout)
        use_color = hasattr(sys.stdout, "isatty") and sys.stdout.isatty()
        handler.setFormatter(logging.Formatter(_FMT if use_color else _PLAIN_FMT,
                                               datefmt=_DATEFMT))
        logger.addHandler(handler)
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        logger._uit_console_sink = True
    return logger
