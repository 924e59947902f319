"""``torch.distributed.checkpoint`` (DCP) checkpoint backend, counterpart
of ``uit_mobile_tpu/ckpt/orbax_io.py``.

The primary format stays the dependency-free ``.npz`` (ckpt/io.py), which
the trainer, the evaluator and the CLIs write and resolve. This module is
the PyTorch-ecosystem alternative for infrastructure built on DCP (sharded
and asynchronous saves, storage layers): the same (params, state, cfg,
extra) contract, stored as a DCP directory with the config and extra in a
``meta.json`` beside its ``.metadata``. It runs in one process with no
process group.

Usage:
    from uit_mobile_tpu_torch.ckpt.dcp_io import save_dcp, load_dcp
    save_dcp(dir, params, state, cfg, extra={"step": 1000})
    params, state, cfg, extra = load_dcp(dir)
"""

from __future__ import annotations

import contextlib
import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from .convert import flatten_tree, unflatten_tree
from .io import config_from_dict, config_to_dict

_SEP = "/"
META = "meta.json"


@contextlib.contextmanager
def _single_process():
    """DCP warns that it runs in one process when no process group exists;
    that is this module's intent."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def is_dcp_dir(p) -> bool:
    """A ``save_dcp`` directory: DCP's ``.metadata`` beside ``meta.json``."""
    p = Path(p)
    return (p / ".metadata").is_file() and (p / META).is_file()


def save_dcp(path, params, state, cfg=None, extra: dict | None = None) -> Path:
    """Write a DCP checkpoint directory at ``path`` (created, or replaced)
    from JAX-layout (params, state) trees of arrays."""
    import torch.distributed.checkpoint as dcp

    path = Path(path).resolve()
    flat = {f"{name}{_SEP}{k}": torch.from_numpy(np.array(v))
            for name, tree in (("params", params), ("state", state or {}))
            for k, v in flatten_tree(tree, _SEP).items()}
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    with _single_process():
        dcp.save(flat, storage_writer=dcp.FileSystemWriter(str(path)), no_dist=True)
    meta = {"config": config_to_dict(cfg) if cfg is not None else None, "extra": extra or {}}
    (path / META).write_text(json.dumps(meta))
    return path


def load_dcp(path):
    """-> (params, state, cfg_or_None, extra), trees of numpy arrays."""
    import torch.distributed.checkpoint as dcp

    path = Path(path).resolve()
    reader = dcp.FileSystemReader(str(path))
    specs = reader.read_metadata().state_dict_metadata
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in specs.items()}
    with _single_process():
        dcp.load(flat, storage_reader=reader, no_dist=True)
    meta = json.loads((path / META).read_text())
    trees = {}
    for name in ("params", "state"):
        prefix = f"{name}{_SEP}"
        trees[name] = unflatten_tree({k[len(prefix):]: v.numpy() for k, v in flat.items()
                                      if k.startswith(prefix)}, _SEP)
    cfg = config_from_dict(meta["config"]) if meta.get("config") else None
    return trees["params"], trees["state"], cfg, meta.get("extra", {})
