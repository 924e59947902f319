"""Native checkpoint save/load, averaging and training state, in the JAX
package's npz format.

One ``.npz`` holds ``params/<key>`` and ``state/<key>`` arrays (keys joined
with ``/``, list indices as digits) plus a ``__meta__`` JSON blob with the
model config and free-form ``extra``: the format of
``uit_mobile_tpu/ckpt/io.py``, so an npz written by either package loads in
the other. A training snapshot adds the optimizer state as ``opt/<i>``
leaves and their count ``n_opt_leaves`` in the meta blob.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..frontend import FrontendConfig
from ..models.mobilenetv2 import MobileNetV2Config
from ..models.uit import UITConfig
from .convert import (flatten_tree, load_numpy, module_from_numpy, module_to_numpy,
                      to_port_layout, unflatten_tree)

_SEP = "/"
_CONFIGS = {"UITConfig": UITConfig, "MobileNetV2Config": MobileNetV2Config}


def config_to_dict(cfg) -> dict:
    """The config as a JSON-able dict (an MoEUITConfig nests its ``base``)."""
    d = dataclasses.asdict(cfg)
    d["__model_config__"] = type(cfg).__name__
    return d


def config_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("__model_config__")
    if kind == "MoEUITConfig":
        # the JAX package's config_from_dict has no MoE entry either
        raise NotImplementedError(
            "config_from_dict cannot rebuild an MoEUITConfig (neither package can); "
            "build it with models.get_model_config('uit_xs_moe', ...)")
    if kind not in _CONFIGS:
        raise NotImplementedError(f"model config {kind!r} is not yet ported")
    if isinstance(d.get("frontend"), dict):
        d["frontend"] = FrontendConfig(**d["frontend"])
    d.pop("grid", None)
    return _CONFIGS[kind](**d)


def _blobs(params, state, cfg, extra, **meta_extra) -> dict:
    blobs = {}
    for name, tree in (("params", params), ("state", state)):
        for k, v in flatten_tree(tree, _SEP).items():
            blobs[f"{name}{_SEP}{k}"] = np.asarray(v)
    meta = {"config": config_to_dict(cfg) if cfg is not None else None,
            "extra": extra or {}, **meta_extra}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    return blobs


def _write_npz(path, blobs: dict) -> None:
    """Atomic write (temp file + rename): a crash mid-write never replaces
    the previous good file with a truncated one."""
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


def save_numpy_checkpoint(path, params, state, cfg=None, extra: dict | None = None) -> None:
    """Write JAX-layout (params, state) numpy trees and the config as an npz."""
    _write_npz(path, _blobs(params, state, cfg, extra))


def save_checkpoint(path, model, cfg=None, extra: dict | None = None,
                    named_params: dict | None = None) -> None:
    """Write ``model`` (and its config) as an npz. ``named_params`` (name ->
    tensor) replaces the module's parameters, as the EMA of the parameters
    does; the buffers are the module's."""
    params, state = module_to_numpy(model, named_params)
    save_numpy_checkpoint(path, params, state, cfg, extra)


def _read(path):
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        flat_p = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
        flat_s = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
        opt = [z[f"opt{_SEP}{i}"] for i in range(meta.get("n_opt_leaves", 0))]
    cfg = config_from_dict(meta["config"]) if meta.get("config") else None
    return (unflatten_tree(flat_p, _SEP), unflatten_tree(flat_s, _SEP), cfg,
            meta.get("extra", {}), opt)


def load_checkpoint(path):
    """-> (params, state, cfg_or_None, extra), trees of numpy arrays."""
    return _read(path)[:4]


def load_model(path, device="cuda", cfg=None):
    """-> (cfg, model on ``device``, extra). ``cfg`` is required only for a
    checkpoint that carries no config."""
    params, state, saved_cfg, extra = load_checkpoint(path)
    cfg = saved_cfg or cfg
    if cfg is None:
        raise ValueError(f"{path} has no embedded config; pass cfg")
    return cfg, module_from_numpy(cfg, params, state, device), extra


def average_checkpoints(paths):
    """Element-wise mean of saved checkpoints -> (params, state, cfg, extra):
    the final deliverable is the mean of the best-k checkpoints. Non-float
    leaves keep the first checkpoint's value; the config and extra are the
    first non-empty ones."""
    paths = list(paths)
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    cfg = extra = None
    for p in paths:
        params, state, cfg_i, extra_i = load_checkpoint(p)
        cfg, extra = cfg or cfg_i, extra or extra_i
        flat = {**{f"p{_SEP}{k}": v for k, v in flatten_tree(params, _SEP).items()},
                **{f"s{_SEP}{k}": v for k, v in flatten_tree(state, _SEP).items()}}
        if acc is None:
            acc = {k: np.array(v) for k, v in flat.items()}
            continue
        if set(flat) != set(acc):
            raise ValueError(f"{p}: parameter keys differ from {paths[0]}")
        for k, v in flat.items():
            if np.issubdtype(acc[k].dtype, np.floating):
                acc[k] = acc[k] + v
    n = float(len(paths))
    avg = {k: (v / n).astype(v.dtype) if np.issubdtype(v.dtype, np.floating) else v
           for k, v in acc.items()}

    def tree(prefix):
        return unflatten_tree({k[2:]: v for k, v in avg.items() if k.startswith(prefix)}, _SEP)

    return tree(f"p{_SEP}"), tree(f"s{_SEP}"), cfg, extra


def save_training_state(path, model, optimizer, cfg=None, extra: dict | None = None) -> None:
    """Full resumable snapshot: params + BN state + the optimizer's state
    leaves (``optimizer.state_leaves()``: moments, counters, EMA,
    accumulated gradients) + ``extra`` (epoch, step, best-k history)."""
    params, state = module_to_numpy(model)
    leaves = [t.detach().cpu().numpy() for t in optimizer.state_leaves()]
    blobs = _blobs(params, state, cfg, extra, n_opt_leaves=len(leaves))
    for i, leaf in enumerate(leaves):
        blobs[f"opt{_SEP}{i}"] = leaf
    _write_npz(path, blobs)


@torch.no_grad()
def load_training_state(path, model, optimizer):
    """Load a ``save_training_state`` snapshot into ``model`` and
    ``optimizer`` (built the same way) in place -> (cfg, extra)."""
    params, state, cfg, extra, opt = _read(path)
    load_numpy(model, params, state)
    optimizer.load_state_leaves([torch.from_numpy(np.asarray(v)) for v in opt])
    return cfg, extra


def load_pretrained_partial(model, params) -> int:
    """Shape-filtered partial load: copy every JAX-layout leaf of ``params``
    whose key and shape match one of ``model``'s parameters, keep the rest
    -> the number of tensors loaded. Positional embeddings of another
    target length do not match; retarget them first with
    ``retarget_pos_embeds``, as the Trainer's ``pretrained:`` load does."""
    own = dict(model.named_parameters())
    n = 0
    with torch.no_grad():
        for k, v in flatten_tree(params, ".").items():
            v = to_port_layout(model, k, np.asarray(v))
            if k in own and tuple(own[k].shape) == v.shape:
                own[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
                n += 1
    if n == 0:
        raise ValueError("couldn't load pretrained model (no overlapping parameters)")
    return n


def retarget_pos_embeds(params: dict, model) -> dict:
    """``params`` with its ``time_pos_embed``/``freq_pos_embed`` resized to
    ``model``'s (``torch_convert.resize_pos_embed``: slice to shrink,
    bilinear to grow), e.g. MAE pretraining at target_length 1012 ->
    fine-tuning at 102, as the JAX Trainer does before its partial load."""
    from .torch_convert import resize_pos_embed

    own = dict(model.named_parameters())
    out = dict(params)
    for key in ("time_pos_embed", "freq_pos_embed"):
        if key in out and key in own and tuple(np.shape(out[key])) != tuple(own[key].shape):
            out[key] = resize_pos_embed(np.asarray(out[key]), own[key].shape[0])
    return out
