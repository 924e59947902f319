"""YAML + CLI-override config, counterpart of ``uit_mobile_tpu/utils/config.py``.

YAML keys, overridden by CLI ``--key value`` pairs, backfilled by
DEFAULT_ARGS. PyYAML is imported only when a file is read, so a config
given as a dict needs no PyYAML.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Any

DEFAULT_ARGS: dict[str, Any] = {
    "outputpath": "experiments",
    "loss": "BCELoss",
    "batch_size": 32,
    "warmup_iters": 1000,
    "mixup": None,
    "num_workers": 2,
    "spectransforms": {},
    "wavtransforms": {},
    "early_stop": 10,
    "epochs": 100,
    "n_saved": 4,
    "optimizer": "Adam",
    "optimizer_args": {"lr": 0.001},
    "epoch_length": None,
    "use_scheduler": True,
    "num_classes": 527,
    "seed": 42,
}


def parse_override(value: str):
    """A CLI override string -> a Python value (ints, floats, bools, None,
    lists/dicts via literal_eval; else the raw string)."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none"):
            return None
        return value


def validate_frontend_precision(config: dict) -> str:
    """The ``frontend_precision`` key ('exact' default, or 'fast'),
    validated before any side effect."""
    fe_prec = str(config.get("frontend_precision", "exact"))
    if fe_prec not in ("exact", "fast"):
        raise ValueError(f"frontend_precision must be 'exact' or 'fast', got {fe_prec!r}")
    return fe_prec


def parse_config_or_kwargs(config_file, default_args: dict | None = None, **kwargs) -> dict:
    """YAML <- CLI kwargs <- defaults merge."""
    import yaml

    with open(config_file) as f:
        yaml_config = yaml.safe_load(f) or {}
    if not isinstance(yaml_config, dict):
        raise ValueError(f"config {config_file} must be a YAML mapping of option keys, "
                         f"got {type(yaml_config).__name__}")
    arguments = dict(yaml_config, **kwargs)
    for key, value in (default_args or DEFAULT_ARGS).items():
        arguments.setdefault(key, value)
    arguments.setdefault("config_stem", Path(config_file).stem)
    return arguments
