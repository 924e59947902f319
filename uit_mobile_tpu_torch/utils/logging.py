"""Logging: a stdout sink configured at first use (loguru-free), and file
sinks for a run's train.log."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

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


def add_file_sink(logger: logging.Logger, path, level=logging.INFO) -> logging.Handler:
    """Attach a file sink (a run's train.log), appending so that a resumed
    run keeps the log of the attempt before it; the caller removes it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(path, mode="a")
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_PLAIN_FMT, datefmt=_DATEFMT))
    logger.addHandler(handler)
    return handler
