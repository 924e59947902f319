"""Plain PyTorch reference of the UiT family and its MoE variant, written
from the published description (arXiv:2303.01812; the repository's MoE
variant: GShard/Switch top-k routing with a per-expert capacity), in
float32 with TF32 off. It imports nothing of the program: it shares only
the parameter names, which are the published checkpoints' keys.

- ``log_mel``: reflect-padded 512-point frames every 160 samples, the
  periodic Hann window, the power spectrum by ``torch.fft.rfft``, the HTK
  mel filterbank (64 bands, 0-8 kHz, no norm) and dB with a 120 dB floor
  below the clip's own maximum (``per_sample``) or the batch's.
- ``encode``: 16x16 patches embedded by one linear map, time and
  frequency position embeddings, pre-LN blocks of bottleneck attention
  (qkv to D/4, the softmax scale of the full-width head, D/heads) and a
  ReLU MLP (or the routed experts), a final LN, the mean over tokens, the
  head's LN and a sigmoid.
- ``train_loss``: the train-mode forward (init_bn on batch statistics) of
  one window, the clamped BCE plus the router's load-balancing loss, and
  init_bn's next running statistics.

The routed MLP computes each expert on the tokens it keeps, by gathering
them (no one-hot dispatch): each token picks its top-k experts (ties to
the lower index), its weights renormalized over them; in round j a token
takes the next slot of its j-th expert, counted over the group's tokens
in order after the slots of earlier rounds, and is dropped past the
capacity C = ceil(k * S / E * factor) (at most k * S) of its group of S
tokens (the tokens of gcd(B, 8) clips).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------- frontend

def mel_filterbank(fe: dict) -> torch.Tensor:
    """(n_fft // 2 + 1, n_mels) HTK triangles, norm None, in float32."""
    n_freqs = fe["n_fft"] // 2 + 1
    freqs = np.linspace(0.0, fe["sample_rate"] / 2, n_freqs)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    m = np.linspace(hz_to_mel(fe["f_min"]), hz_to_mel(fe["f_max"]), fe["n_mels"] + 2)
    f = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    lower = (freqs[:, None] - f[None, :-2]) / (f[1:-1] - f[:-2])[None, :]
    upper = (f[None, 2:] - freqs[:, None]) / (f[2:] - f[1:-1])[None, :]
    return torch.from_numpy(np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32))


def log_mel(wav: torch.Tensor, fe: dict, per_sample: bool,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T) int16 PCM or float waves -> (B, n_mels, frames) dB in ``dtype``
    (float32; float64 gives a witness of float32's rounding)."""
    x = wav.to(dtype) / 32768.0 if wav.dtype == torch.int16 else wav.to(dtype)
    pad = fe["n_fft"] // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, fe["n_fft"], fe["hop_length"])
    window = torch.hann_window(fe["win_length"], periodic=True, device=x.device, dtype=dtype)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ mel_filterbank(fe).to(x.device, dtype)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    top = db.amax(dim=(1, 2), keepdim=True) if per_sample else db.max()
    return torch.maximum(db, top - fe["top_db"]).transpose(1, 2)


# ---------------------------------------------------------------- weights

def inner_dim(cfg: dict) -> int:
    return cfg["embed_dim"] // 4 if cfg["attention"] == "BNeckAttention" else cfg["embed_dim"]


def param_specs(cfg: dict) -> list:
    """(name, shape, kind, scale[, base]) of every tensor, for ``gen.weights``:
    linear maps at std 1/sqrt(fan_in), biases and position embeddings small,
    norms near 1, init_bn's running statistics on the scale of a mel in dB."""
    D, ps, F_ = cfg["embed_dim"], cfg["patch_size"], cfg["n_mels"]
    H, inner = int(D * cfg["mlp_ratio"]), inner_dim(cfg)
    tg = cfg["target_length"] // ps

    def lin(name, a, b):
        return [(f"{name}.kernel", (a, b), "normal", a ** -0.5),
                (f"{name}.bias", (b,), "normal", 0.02)]

    def norm(name):
        return [(f"{name}.scale", (D,), "one", 0.1), (f"{name}.bias", (D,), "normal", 0.1)]

    specs = [("cls_token", (1, 1, D), "normal", 0.02), ("token_pos_embed", (1, D), "normal", 0.02),
             ("time_pos_embed", (tg, D), "normal", 0.1),
             ("freq_pos_embed", (F_ // ps, D), "normal", 0.1),
             ("init_bn.scale", (F_,), "one", 0.1), ("init_bn.bias", (F_,), "normal", 0.1),
             ("init_bn.mean", (F_,), "normal", 5.0), ("init_bn.var", (F_,), "var", 0.2, 100.0)]
    specs += lin("patch_embed", ps * ps, D)
    moe = cfg.get("moe")
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        specs += norm(f"{b}.norm1") + lin(f"{b}.attn.qkv", D, 3 * inner)
        specs += lin(f"{b}.attn.proj", inner, D) + norm(f"{b}.norm2")
        if moe is None:
            specs += lin(f"{b}.mlp.fc1", D, H) + lin(f"{b}.mlp.fc2", H, D)
        else:
            E = moe["n_experts"]
            specs += [(f"{b}.moe.router.kernel", (D, E), "normal", D ** -0.5),
                      (f"{b}.moe.fc1.kernel", (E, D, H), "normal", D ** -0.5),
                      (f"{b}.moe.fc1.bias", (E, H), "normal", 0.02),
                      (f"{b}.moe.fc2.kernel", (E, H, D), "normal", H ** -0.5),
                      (f"{b}.moe.fc2.bias", (E, D), "normal", 0.02)]
    return specs + norm("norm") + norm("head_norm") + lin("head", D, cfg["outputdim"])


# ---------------------------------------------------------------- encoder

def _ln(W, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.scale"], W[f"{name}.bias"], eps)


def _lin(W, name, x):
    return x @ W[f"{name}.kernel"] + W[f"{name}.bias"]


def tokens(cfg: dict, W: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) normalized mel -> (B, fg * tg, D) embedded patches,
    frequency-major."""
    B, F_, T = x.shape
    ps = cfg["patch_size"]
    fg, tg = F_ // ps, T // ps
    x = x[:, :fg * ps, :tg * ps].reshape(B, fg, ps, tg, ps).permute(0, 1, 3, 2, 4)
    t = _lin(W, "patch_embed", x.reshape(B, fg, tg, ps * ps))
    t = t + W["time_pos_embed"][:tg] + W["freq_pos_embed"][:, None]
    return t.reshape(B, fg * tg, -1)


def attention(cfg: dict, W: dict, b: str, h: torch.Tensor) -> torch.Tensor:
    B, N, D = h.shape
    heads, inner = cfg["num_heads"], inner_dim(cfg)
    q, k, v = _lin(W, f"{b}.attn.qkv", h).split(inner, dim=-1)

    def split(t):
        return t.reshape(B, N, heads, inner // heads).transpose(1, 2)

    scale = (D // heads) ** -0.5
    a = torch.softmax(split(q) @ split(k).transpose(-1, -2) * scale, dim=-1)
    o = (a @ split(v)).transpose(1, 2).reshape(B, N, inner)
    return _lin(W, f"{b}.attn.proj", o)


def routed_mlp(cfg: dict, W: dict, b: str, h: torch.Tensor,
               routes: Optional[list] = None) -> tuple:
    """(B, N, D) -> ((B, N, D), load-balancing loss) (module docstring).
    ``routes``: a list that gets each token's top-k experts, (B * N, k)."""
    moe = cfg["moe"]
    B, N, D = h.shape
    E, k = moe["n_experts"], moe["top_k"]
    x = h.reshape(B * N, D)
    gates = torch.softmax(x @ W[f"{b}.moe.router.kernel"], dim=-1)
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = order.values[:, :k], order.indices[:, :k]
    if routes is not None:
        routes.append(top_e)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    S = N * math.gcd(B, 8)
    G = B * N // S
    C = max(1, min(math.ceil(k * S / E * moe["capacity_factor"]), k * S))
    e_g = top_e.reshape(G, S, k)
    taken = torch.zeros(G, E, dtype=torch.long, device=h.device)
    y = torch.zeros_like(x)
    for j in range(k):
        onehot = F.one_hot(e_g[:, :, j], E)                          # (G, S, E)
        before = torch.cumsum(onehot, dim=1) - onehot + taken[:, None, :]
        slot = before.gather(2, e_g[:, :, j, None])[..., 0]          # (G, S)
        kept = (slot < C).reshape(-1)
        taken = taken + onehot.sum(dim=1)
        for e in range(E):
            idx = torch.nonzero(kept & (top_e[:, j] == e))[:, 0]
            z = torch.relu(x[idx] @ W[f"{b}.moe.fc1.kernel"][e] + W[f"{b}.moe.fc1.bias"][e])
            out = z @ W[f"{b}.moe.fc2.kernel"][e] + W[f"{b}.moe.fc2.bias"][e]
            y = y.index_add(0, idx, top_w[idx, j, None] * out)
    first = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(first * gates.mean(dim=0))
    return y.reshape(B, N, D), aux


def encode(cfg: dict, W: dict, x: torch.Tensor, routes: Optional[list] = None) -> tuple:
    """(B, n_mels, T <= target_length) normalized mel -> ((B, outputdim)
    probabilities, the mean over blocks of the routing loss or 0);
    ``routes`` gets each routed block's top-k experts."""
    t = tokens(cfg, W, x)
    aux = 0.0
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        t = t + attention(cfg, W, b, _ln(W, f"{b}.norm1", t, 1e-6))
        h = _ln(W, f"{b}.norm2", t, 1e-6)
        if cfg.get("moe") is None:
            t = t + _lin(W, f"{b}.mlp.fc2", torch.relu(_lin(W, f"{b}.mlp.fc1", h)))
        else:
            y, a = routed_mlp(cfg, W, b, h, routes)
            t, aux = t + y, aux + a
    pooled = _ln(W, "norm", t, 1e-6).mean(dim=1)
    probs = torch.sigmoid(_lin(W, "head", _ln(W, "head_norm", pooled, 1e-5)))
    return probs, aux / cfg["depth"]


def bce(probs: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    p = probs.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p)).mean()


def train_loss(cfg: dict, W: dict, mel: torch.Tensor, target: torch.Tensor,
               routes: Optional[list] = None) -> tuple:
    """One train-mode window -> (loss, bce, aux, init_bn's next running
    mean and variance); ``routes`` as ``encode``'s."""
    mean = mel.mean(dim=(0, 2))
    var = mel.var(dim=(0, 2), unbiased=False)
    n = mel.shape[0] * mel.shape[2]
    x = (mel - mean[:, None]) * torch.rsqrt(var[:, None] + 1e-5)
    x = x * W["init_bn.scale"][:, None] + W["init_bn.bias"][:, None]
    probs, aux = encode(cfg, W, x, routes)
    loss_bce = bce(probs, target)
    loss = loss_bce + cfg["moe"]["router_aux_weight"] * aux
    m = 0.01
    with torch.no_grad():
        run_mean = (1 - m) * W["init_bn.mean"] + m * mean
        run_var = (1 - m) * W["init_bn.var"] + m * var * n / (n - 1)
    return loss, loss_bce, aux, run_mean, run_var
