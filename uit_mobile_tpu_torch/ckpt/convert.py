"""Weights carried between the JAX package and the port.

The JAX package keeps (params, state) as nested dicts and lists of arrays
(``jax.tree.map(np.asarray, params)`` gives numpy leaves). The port's
``UiT`` module names its parameters after the same keys, so the carry is a
key-for-key copy: JAX ``blocks/3/attn/qkv/kernel`` is the port's
``blocks.3.attn.qkv.kernel`` (params -> parameters, state -> buffers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.uit import UiT, UITConfig
from ..utils.device import resolve_device


def flatten_tree(tree, sep: str, prefix: str = "") -> dict:
    """Nested dicts/lists -> {joined key: leaf}. A nested empty container
    would vanish from the flat form, so it is refused."""
    out = {}
    if isinstance(tree, (dict, list, tuple)):
        if not tree and prefix:
            raise ValueError(f"cannot flatten empty container at '{prefix[:-len(sep)]}'")
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(flatten_tree(v, sep, f"{prefix}{k}{sep}"))
    else:
        out[prefix[:-len(sep)]] = tree
    return out


def unflatten_tree(flat: dict, sep: str):
    """{joined key: leaf} -> nested dicts, with all-digit key sets as lists."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx != list(range(len(idx))):
                raise ValueError(f"non-contiguous list indices {idx}")
            return [listify(node[str(i)]) for i in idx]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


@torch.no_grad()
def module_from_numpy(cfg: UITConfig, params, state, device="cuda") -> UiT:
    """JAX-layout (params, state) trees of numpy arrays -> the port's UiT on
    ``device``. Every key must match, with its shape."""
    dev = resolve_device(device)
    model = UiT(cfg)
    flat = {**flatten_tree(params, "."), **flatten_tree(state or {}, ".")}
    sd = model.state_dict()
    missing, unexpected = sorted(set(sd) - set(flat)), sorted(set(flat) - set(sd))
    if missing or unexpected:
        raise KeyError(f"parameter trees do not match the {type(model).__name__} "
                       f"of this config: missing {missing}, unexpected {unexpected}")
    for k, v in flat.items():
        v = np.asarray(v)
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: shape {v.shape} != expected {tuple(sd[k].shape)}")
        sd[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
    return model.to(dev).eval()


def module_to_numpy(model: UiT):
    """The port's UiT -> JAX-layout (params, state) trees of numpy arrays."""
    params = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
    state = {k: v.detach().cpu().numpy() for k, v in model.named_buffers()}
    return unflatten_tree(params, "."), unflatten_tree(state, ".")
