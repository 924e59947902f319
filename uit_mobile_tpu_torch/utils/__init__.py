from .config import (DEFAULT_ARGS, parse_config_or_kwargs, parse_override,
                     validate_frontend_precision)
from .device import resolve_device
from .logging import add_file_sink, get_logger

__all__ = [
    "DEFAULT_ARGS",
    "add_file_sink",
    "get_logger",
    "parse_config_or_kwargs",
    "parse_override",
    "resolve_device",
    "validate_frontend_precision",
]
