"""Weights carried between the JAX package and the port.

The JAX package keeps (params, state) as nested dicts and lists of arrays
(``jax.tree.map(np.asarray, params)`` gives numpy leaves). The port's
modules name their parameters after the same keys, so the carry is a
key-for-key copy: JAX ``blocks/3/attn/qkv/kernel`` is the port's
``blocks.3.attn.qkv.kernel`` (params -> parameters, state -> buffers).
One layout differs: MobileNetV2's conv kernels are HWIO ``(k, k, cin/g,
cout)`` in JAX and OIHW in the port (``permute(3, 2, 0, 1)``).

A placed model (TP, EP, FSDP or hybrid: ``model.shards``, parallel/tp.py)
is carried whole, as JAX's ``np.asarray`` of a sharded array is:
``module_to_numpy`` gathers every split parameter over its groups (a
collective: every rank calls it), and ``load_numpy`` keeps this rank's
slice of each whole array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import module_class
from ..models.mobilenetv2 import MobileNetV2, MobileNetV2Config
from ..utils.device import resolve_device


def _hwio(cfg_or_model) -> bool:
    """Whether this model family stores conv kernels HWIO in JAX."""
    return isinstance(cfg_or_model, (MobileNetV2, MobileNetV2Config))


def to_port_layout(cfg, key: str, value: np.ndarray) -> np.ndarray:
    """One JAX-layout leaf -> the port's layout."""
    if _hwio(cfg) and key.endswith("conv.kernel"):
        return np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    return value


def to_jax_layout(cfg, key: str, value: np.ndarray) -> np.ndarray:
    """One port-layout leaf -> the JAX package's layout."""
    if _hwio(cfg) and key.endswith("conv.kernel"):
        return np.transpose(value, (2, 3, 1, 0))  # OIHW -> HWIO
    return value


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


def placement(model) -> dict:
    """``model.shards`` (per split parameter its (dim, axis, group)
    triples), {} for a whole model. A placed model outside the process
    group its shards name is refused: nothing could gather them."""
    shards = getattr(model, "shards", None) or {}
    if shards:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise ValueError(f"this {type(model).__name__} is placed over a process group "
                             f"(model.shards) that is not initialized: its whole tensors "
                             f"are gathered by every rank of that group together")
    return shards


def gather_whole(model, tensors: dict) -> dict:
    """name -> tensor placed like that parameter of ``model`` (the parameter
    itself, its EMA or an optimizer moment) -> name -> the whole tensor on
    the CPU. On a placed model a collective (``parallel.tp.gather_params``)."""
    if not placement(model):
        return {k: v.detach().cpu() for k, v in tensors.items()}
    from ..parallel.tp import gather_params

    return gather_params(model, tensors)


def local_slice(model, name: str, value: np.ndarray) -> np.ndarray:
    """This rank's slice of the whole array ``value`` of parameter ``name``,
    as the placement cut it (parallel/tp.py:place_params): each split dim
    in turn, the rank's chunk of its group."""
    import torch.distributed as dist

    for dim, _, group in placement(model).get(name, ()):
        n = dist.get_world_size(group)
        value = np.split(value, n, axis=dim)[dist.get_rank(group)]
    return value


@torch.no_grad()
def load_numpy(model, params, state):
    """Copy JAX-layout (params, state) trees of numpy arrays into ``model``
    (any port container: UiT, MobileNetV2, an MAE) in place -> model.
    Every key must match, with its shape; a placed model takes this rank's
    slice of each whole array (``local_slice``)."""
    flat = {**flatten_tree(params, "."), **flatten_tree(state or {}, ".")}
    sd = model.state_dict()
    missing, unexpected = sorted(set(sd) - set(flat)), sorted(set(flat) - set(sd))
    if missing or unexpected:
        raise KeyError(f"parameter trees do not match the {type(model).__name__} "
                       f"of this config: missing {missing}, unexpected {unexpected}")
    for k, v in flat.items():
        v = local_slice(model, k, to_port_layout(model, k, np.asarray(v)))
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: shape {v.shape} != expected {tuple(sd[k].shape)}")
        sd[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
    return model


def module_from_numpy(cfg, params, state, device="cuda"):
    """JAX-layout (params, state) trees of numpy arrays -> the port's model
    of ``cfg`` (UiT or MobileNetV2) on ``device``, in eval mode."""
    dev = resolve_device(device)
    return load_numpy(module_class(cfg)(cfg), params, state).to(dev).eval()


def module_to_numpy(model, named_params=None):
    """The port's model -> JAX-layout (params, state) trees of numpy arrays.
    ``named_params`` (name -> tensor) replaces the module's parameters, as
    the EMA of the parameters does. On a placed model the whole tensors,
    gathered: every rank calls it."""
    params = dict(model.named_parameters()) if named_params is None else named_params
    params = {k: to_jax_layout(model, k, v.numpy()) for k, v in gather_whole(model, params).items()}
    state = {k: v.detach().cpu().numpy() for k, v in model.named_buffers()}
    return unflatten_tree(params, "."), unflatten_tree(state, ".")
