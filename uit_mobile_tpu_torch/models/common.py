"""NN primitives of the model family, counterpart of
``uit_mobile_tpu/models/common.py``.

Parameters live in small ``nn.Module`` containers whose attribute names are
the JAX pytree's keys, so a JAX flat key ``blocks/3/attn/qkv/kernel`` is the
port's ``blocks.3.attn.qkv.kernel``. Linear kernels keep the JAX layout
``(in, out)`` (``y = x @ kernel + bias``, i.e. torch ``Linear.weight.T``).
The functions below take such a container as ``p``, like their JAX
counterparts take a dict. Train-mode randomness (dropout, drop-path) is
drawn from an explicit ``torch.Generator`` where JAX takes a key.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.rows import current as current_rows
from ..parallel.rows import rand_rows


# ---------------------------------------------------------------- containers

class Linear(nn.Module):
    """{'kernel': (in, out), 'bias': (out,)}; no 'bias' entry without bias."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        if bias:
            self.bias = nn.Parameter(torch.zeros(d_out))
        else:
            self.register_parameter("bias", None)


class LayerNorm(nn.Module):
    """{'scale': ones, 'bias': zeros} (layer_norm_init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class BatchNorm(nn.Module):
    """Affine params {'scale', 'bias'} plus running stats {'mean', 'var'} as
    buffers: the JAX ``params`` and ``state`` entries of one BatchNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(init_values * torch.ones(dim))


# -------------------------------------------------------------- init helpers

def trunc_normal(generator: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    """timm-style truncated normal in [-2std, 2std] (reference uit.py:371)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return t


@torch.no_grad()
def linear_init(generator: torch.Generator, p: Linear, std: float = 0.02) -> None:
    """Fill a Linear with trunc_normal(std) kernel and zero bias."""
    p.kernel.copy_(trunc_normal(generator, tuple(p.kernel.shape), std=std))
    if p.bias is not None:
        p.bias.zero_()


def conv2d_torch_default_init(generator: torch.Generator, shape):
    """torch Conv2d default (kaiming-uniform a=sqrt(5) => U[-b, b]).

    shape = (kh, kw, c_in, c_out), fan_in = kh*kw*c_in. -> (kernel, bias)."""
    kh, kw, c_in, c_out = shape
    bound = 1.0 / math.sqrt(kh * kw * c_in)
    kernel = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    bias = torch.empty(c_out).uniform_(-bound, bound, generator=generator)
    return kernel, bias


# ---------------------------------------------------------------- primitives

def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)  # jnp.var is biased
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p.scale + p.bias


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.kernel
    if p.bias is not None:
        y = y + p.bias
    return y


def _generator(generator, what: str):
    if generator is None:
        raise ValueError(f"{what} in train mode needs a torch.Generator")
    return generator


def dropout(generator, x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(_generator(generator, "dropout"), x.shape, x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def drop_path(generator, x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    """Stochastic depth: drop whole residual branches per sample."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = rand_rows(_generator(generator, "drop_path"), shape, x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def batch_norm_inference(p: BatchNorm, x: torch.Tensor, axis: int = -1,
                         eps: float = 1e-5) -> torch.Tensor:
    """Per-channel affine with the running stats; ``axis`` is the channel axis."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]

    def r(v):
        return v.reshape(shape)

    inv = torch.rsqrt(r(p.var) + eps)
    return (x - r(p.mean)) * inv * r(p.scale) + r(p.bias)


def batch_norm_train(p: BatchNorm, x: torch.Tensor, axis: int = -1,
                     momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm with batch statistics -> (y, new_state), torch semantics:
    normalized with the biased batch variance, the running variance moved
    toward the *unbiased* one. new_state = {'mean', 'var'} (no grad); the
    module's buffers are left as they are. Under ``parallel.rows.sharded``
    the statistics are the global batch's: the mean of the ranks' means,
    the mean of their variances plus their means' squared offsets (equal
    counts), and the unbiased count global."""
    axis = axis % x.dim()
    reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
    mean = x.mean(dim=reduce_dims)
    var = x.var(dim=reduce_dims, unbiased=False)
    n = x.numel() // x.shape[axis]
    rows = current_rows()
    if rows is not None:
        local_mean, mean = mean, rows.mean(mean)
        var = rows.mean(var + (local_mean - mean) ** 2)
        n *= rows.world
    with torch.no_grad():
        unbiased = var * n / max(n - 1, 1)
        new_state = {"mean": (1 - momentum) * p.mean + momentum * mean,
                     "var": (1 - momentum) * p.var + momentum * unbiased}
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]

    def r(v):
        return v.reshape(shape)

    y = (x - r(mean)) * torch.rsqrt(r(var) + eps) * r(p.scale) + r(p.bias)
    return y, new_state


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
}


def multihead_attention(p, x: torch.Tensor, num_heads: int, scale: float,
                        inner_dim: int, causal: bool = False,
                        key_mask: torch.Tensor | None = None,
                        attn_drop: float = 0.0, proj_drop: float = 0.0,
                        generator=None, deterministic: bool = True) -> torch.Tensor:
    """Full/bottleneck multi-head self-attention.

    ``p`` holds ``qkv`` (D -> 3*inner) and ``proj`` (inner -> D). The
    reference's ``scale`` is the FULL-dim head size (uit.py:99-100), passed
    in by the caller. Logits and softmax in float32, as explicit matmuls."""
    B, N, _ = x.shape
    hd = inner_dim // num_heads
    qkv = linear(p.qkv, x)  # (B, N, 3*inner)
    heads = []
    for i in range(num_heads):
        q = qkv[..., i * hd:(i + 1) * hd]
        k = qkv[..., inner_dim + i * hd: inner_dim + (i + 1) * hd]
        v = qkv[..., 2 * inner_dim + i * hd: 2 * inner_dim + (i + 1) * hd]
        attn = (q.float() @ k.float().transpose(-1, -2)) * scale
        min_val = torch.finfo(attn.dtype).min
        if causal:
            upper = torch.ones(N, N, dtype=torch.bool, device=x.device).triu(1)
            attn = attn.masked_fill(upper, min_val)
        if key_mask is not None:  # (B, N) True = valid key token
            attn = attn.masked_fill(~key_mask[:, None, :], min_val)
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(generator, attn, attn_drop, deterministic)
        heads.append(attn.to(v.dtype) @ v)
    out = heads[0] if num_heads == 1 else torch.cat(heads, dim=-1)
    out = linear(p.proj, out.to(x.dtype))
    return dropout(generator, out, proj_drop, deterministic)


def mlp(p, x: torch.Tensor, act: str, drop: float = 0.0, generator=None,
        deterministic: bool = True) -> torch.Tensor:
    x = dropout(generator, ACTIVATIONS[act](linear(p.fc1, x)), drop, deterministic)
    return dropout(generator, linear(p.fc2, x), drop, deterministic)
