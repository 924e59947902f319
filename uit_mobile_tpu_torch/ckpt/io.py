"""Native checkpoint save/load, in the JAX package's npz format.

One ``.npz`` holds ``params/<key>`` and ``state/<key>`` arrays (keys joined
with ``/``, list indices as digits) plus a ``__meta__`` JSON blob with the
model config and free-form ``extra``: the format of
``uit_mobile_tpu/ckpt/io.py``, so an npz written by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from ..frontend import FrontendConfig
from ..models.uit import UiT, UITConfig
from .convert import flatten_tree, module_from_numpy, module_to_numpy, unflatten_tree

_SEP = "/"


def config_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["__model_config__"] = type(cfg).__name__
    return d


def config_from_dict(d: dict) -> UITConfig:
    d = dict(d)
    kind = d.pop("__model_config__")
    if kind != "UITConfig":
        raise NotImplementedError(f"model config {kind!r} is not yet ported")
    if isinstance(d.get("frontend"), dict):
        d["frontend"] = FrontendConfig(**d["frontend"])
    d.pop("grid", None)
    return UITConfig(**d)


def save_checkpoint(path, model: UiT, cfg=None, extra: dict | None = None) -> None:
    """Write ``model`` (and its config) as an npz; atomic (temp file + rename)."""
    params, state = module_to_numpy(model)
    blobs = {}
    for name, tree in (("params", params), ("state", state)):
        for k, v in flatten_tree(tree, _SEP).items():
            blobs[f"{name}{_SEP}{k}"] = np.asarray(v)
    meta = {"config": config_to_dict(cfg) if cfg is not None else None,
            "extra": extra or {}}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = Path(path)
    if not str(path).endswith(".npz"):  # mirror np.savez's appending
        path = Path(str(path) + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}.npz")
    try:
        np.savez(tmp, **blobs)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_checkpoint(path):
    """-> (params, state, cfg_or_None, extra), trees of numpy arrays."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        flat_p = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
        flat_s = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
    cfg = config_from_dict(meta["config"]) if meta.get("config") else None
    return (unflatten_tree(flat_p, _SEP), unflatten_tree(flat_s, _SEP), cfg,
            meta.get("extra", {}))


def load_model(path, device="cuda", cfg: UITConfig | None = None):
    """-> (cfg, model on ``device``, extra). ``cfg`` is required only for a
    checkpoint that carries no config."""
    params, state, saved_cfg, extra = load_checkpoint(path)
    cfg = saved_cfg or cfg
    if cfg is None:
        raise ValueError(f"{path} has no embedded config; pass cfg")
    return cfg, module_from_numpy(cfg, params, state, device), extra
