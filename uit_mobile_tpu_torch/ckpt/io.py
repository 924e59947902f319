"""Native checkpoint save/load, averaging and training state, in the JAX
package's npz format.

One ``.npz`` holds ``params/<key>`` and ``state/<key>`` arrays (keys joined
with ``/``, list indices as digits) plus a ``__meta__`` JSON blob with the
model config and free-form ``extra``: the format of
``uit_mobile_tpu/ckpt/io.py``, so an npz written by either package loads in
the other. A training snapshot adds the optimizer state as ``opt/<i>``
leaves and their count ``n_opt_leaves`` in the meta blob.

A placed model (TP, EP, FSDP or hybrid: ``model.shards``) is written
whole, as JAX writes a sharded params tree: ``save_checkpoint`` and
``save_training_state`` are then collectives that every rank of its
process group calls; they gather the parameters (or the EMA) and the
optimizer leaves placed like them, the main rank (0) writes, and every
rank learns whether it did. The file is the one the unplaced model with
the same values writes. ``load_training_state`` gives each rank its slice.
The trainers save from their main rank alone, so they save unplaced
models only: a placed save on one rank alone would wait for the others.
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
from .convert import (flatten_tree, gather_whole, load_numpy, local_slice, module_from_numpy,
                      module_to_numpy, placement, to_port_layout, unflatten_tree)

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


def _write_from_main(model, path, blobs: dict) -> None:
    """``_write_npz`` in one process; for a placed model (every rank calls)
    on the main rank, its failure raised on every rank."""
    if not placement(model):
        _write_npz(path, blobs)
        return
    import torch.distributed as dist

    error = None
    if dist.get_rank() == 0:
        try:
            _write_npz(path, blobs)
        except Exception as e:  # noqa: BLE001 - raised below, after the others hear of it
            error = e
    failed = torch.tensor([error is not None], dtype=torch.int32)
    if dist.get_backend() == "nccl":  # NCCL carries CUDA tensors only
        failed = failed.to(next(model.parameters()).device)
    dist.all_reduce(failed, op=dist.ReduceOp.MAX)
    if error is not None:
        raise error
    if failed.item():
        raise RuntimeError(f"the main rank failed to write {path}")


def save_numpy_checkpoint(path, params, state, cfg=None, extra: dict | None = None) -> None:
    """Write JAX-layout (params, state) numpy trees and the config as an npz."""
    _write_npz(path, _blobs(params, state, cfg, extra))


def save_checkpoint(path, model, cfg=None, extra: dict | None = None,
                    named_params: dict | None = None) -> None:
    """Write ``model`` (and its config) as an npz. ``named_params`` (name ->
    tensor) replaces the module's parameters, as the EMA of the parameters
    does; the buffers are the module's. A placed model is written whole by
    every rank together (the module docstring)."""
    params, state = module_to_numpy(model, named_params)
    _write_from_main(model, path, _blobs(params, state, cfg, extra))


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
    accumulated gradients) + ``extra`` (epoch, step, best-k history). A
    placed model and its optimizer are written whole by every rank
    together (the module docstring)."""
    params, state = module_to_numpy(model)
    leaves = [t.numpy() for t in _whole_leaves(model, optimizer)]
    blobs = _blobs(params, state, cfg, extra, n_opt_leaves=len(leaves))
    for i, leaf in enumerate(leaves):
        blobs[f"opt{_SEP}{i}"] = leaf
    _write_from_main(model, path, blobs)


def _by_parameter(optimizer, leaves: list) -> list:
    """``optimizer.state_leaves()``' order after the counters: one list a
    parameter in ``optimizer.names``' order for each of the moments, the
    EMA and the accumulated gradients -> those lists."""
    n, rest = len(optimizer.names), leaves[1:]
    if n == 0 or len(rest) % n:
        raise ValueError(f"{len(rest)} optimizer leaves are not lists of the {n} parameters")
    return [rest[i:i + n] for i in range(0, len(rest), n)]


def _whole_leaves(model, optimizer) -> list:
    """The optimizer's state leaves on the CPU, those placed like a
    parameter gathered whole on a placed model (a collective)."""
    leaves = optimizer.state_leaves()
    if not placement(model):
        return [t.detach().cpu() for t in leaves]
    out = [leaves[0].detach().cpu()]
    for group in _by_parameter(optimizer, leaves):
        whole = gather_whole(model, dict(zip(optimizer.names, group)))
        out.extend(whole[name] for name in optimizer.names)
    return out


@torch.no_grad()
def load_training_state(path, model, optimizer):
    """Load a ``save_training_state`` snapshot into ``model`` and
    ``optimizer`` (built the same way) in place -> (cfg, extra). A placed
    model and its optimizer take this rank's slice of each whole array."""
    params, state, cfg, extra, opt = _read(path)
    load_numpy(model, params, state)
    if placement(model):
        opt = opt[:1] + [local_slice(model, name, v) for group in _by_parameter(optimizer, opt)
                         for name, v in zip(optimizer.names, group)]
    optimizer.load_state_leaves([torch.from_numpy(np.ascontiguousarray(v)) for v in opt])
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
