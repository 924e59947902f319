"""UiT audio transformer family, counterpart of
``uit_mobile_tpu/models/uit.py``.

The model is a ``UiT`` ``nn.Module`` whose parameter names mirror the JAX
pytree (``blocks.3.attn.qkv.kernel`` <-> ``blocks/3/attn/qkv/kernel``; the
init_bn running stats are buffers ``init_bn.mean`` / ``init_bn.var``, the
JAX ``state``). The forward functions take ``(cfg, model, ...)`` where the
JAX ones take ``(cfg, params, state, ...)``.

Checkpoint-parity quirks kept:
- BNeckAttention's softmax scale uses the FULL-dim head size (uit.py:99-101);
- block/final LayerNorms use eps=1e-6, the head LayerNorm eps=1e-5;
- the head emits sigmoid probabilities;
- pooling='dm' does freq-mean -> head -> sigmoid -> time-mean;
- long clips are cut into target_length windows, the short tail replaced by
  the last full window, and scores reduced by ``eval_avg``.

Training (``forward(..., train=True)``) returns ``(probs, new_state)``: the
init_bn running statistics after this batch as a dict keyed by buffer name
(``init_bn.mean``/``init_bn.var``, momentum 0.01), which the caller writes
back (``load_state``); the module itself is not changed. Dropout, drop-path,
patch dropout and the augments draw from an explicit ``torch.Generator``.

``compute_dtype='bfloat16'`` follows the JAX rule: the residual stream is
bfloat16 from the end of ``_prepare_tokens``; LayerNorm inputs go to
float32 and come back; the attention and MLP weights and the LayerScale
gammas are cast to bfloat16 per use (the float32 parameters stay the
master copy and take the gradients); attention logits and softmax stay
float32; the final norm and the head run in float32.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..frontend import FrontendConfig, log_mel_spectrogram
from ..augment.mixup import mixup_tensor
from .common import (
    BatchNorm,
    LayerNorm,
    LayerScale,
    Linear,
    batch_norm_inference,
    batch_norm_train,
    conv2d_torch_default_init,
    drop_path,
    dropout,
    layer_norm,
    linear,
    linear_init,
    mlp,
    multihead_attention,
)


@dataclasses.dataclass(frozen=True)
class UITConfig:
    outputdim: int = 527
    patch_size: int = 16
    patch_stride: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    init_bn: bool = True
    init_values: Optional[float] = None
    target_length: int = 1012
    pooling: str = "token"  # 'token' | 'mean' | 'dm'
    attention_type: str = "Attention"  # 'Attention' | 'BNeckAttention'
    act: str = "gelu"
    eval_avg: str = "mean"  # long-clip score reduction: 'mean' | 'max'
    time_patch_out: Optional[float] = None
    freq_patch_out: Optional[float] = None
    n_mels: int = 64
    causal: bool = False
    use_length_mask: bool = False
    compute_dtype: str = "float32"
    # mel orientation the frontend_fn delivers: 'bft' (B, n_mels, T),
    # 'btf' (B, T, n_mels) or 'tfb' (T, n_mels, B); btf/tfb fold init_bn
    # into the patch embed (eval only)
    mel_layout: str = "bft"
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)

    def __post_init__(self):
        def check(ok, msg):
            if not ok:
                raise ValueError(msg)

        check(self.pooling in ("mean", "token", "dm"),
              f"unknown pooling {self.pooling!r}")
        check(self.attention_type in ("Attention", "BNeckAttention"),
              f"unknown attention_type {self.attention_type!r}")
        check(self.embed_dim % self.num_heads == 0,
              f"embed_dim {self.embed_dim} % num_heads {self.num_heads}")
        check(self.eval_avg in ("mean", "max"),
              f"unknown eval_avg {self.eval_avg!r}")
        check(self.mel_layout in ("bft", "btf", "tfb"),
              f"unknown mel_layout {self.mel_layout!r}")
        check(self.patch_stride == self.patch_size,
              f"patch_stride {self.patch_stride} != patch_size "
              f"{self.patch_size}: the reshape patch embed cannot express "
              f"overlapping patches")
        check(not (self.pooling == "dm" and self.freq_patch_out),
              "pooling='dm' is incompatible with freq_patch_out")
        check(self.compute_dtype in ("float32", "bfloat16"),
              f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}")

    @property
    def grid_size(self):  # (freq, time) patch grid
        return (
            self.n_mels // self.patch_stride,
            self.target_length // self.patch_stride,
        )

    @property
    def inner_dim(self) -> int:
        if self.attention_type == "BNeckAttention":
            return self.embed_dim // 4
        return self.embed_dim

    @property
    def attn_scale(self) -> float:
        # Reference quirk (uit.py:99-100, 136-137): always the FULL-dim head.
        return float((self.embed_dim // self.num_heads) ** -0.5)


# ------------------------------------------------------------------- modules

class Attention(nn.Module):
    def __init__(self, cfg: UITConfig):
        super().__init__()
        self.qkv = Linear(cfg.embed_dim, 3 * cfg.inner_dim, bias=cfg.qkv_bias)
        self.proj = Linear(cfg.inner_dim, cfg.embed_dim)


class MLP(nn.Module):
    def __init__(self, cfg: UITConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = Linear(cfg.embed_dim, hidden)
        self.fc2 = Linear(hidden, cfg.embed_dim)


class Block(nn.Module):
    def __init__(self, cfg: UITConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(D)
        self.mlp = MLP(cfg)
        if cfg.init_values is not None:
            self.ls1 = LayerScale(D, cfg.init_values)
            self.ls2 = LayerScale(D, cfg.init_values)


class UiT(nn.Module):
    """Parameter container of one UiT model (zeros/ones; ``init`` fills it).
    The forward is the function ``forward(cfg, model, wav)`` below."""

    def __init__(self, cfg: UITConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        fg, tg = cfg.grid_size
        if cfg.init_bn:
            self.init_bn = BatchNorm(cfg.n_mels)
        self.patch_embed = Linear(cfg.patch_size * cfg.patch_size, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.token_pos_embed = nn.Parameter(torch.zeros(1, D))
        self.time_pos_embed = nn.Parameter(torch.zeros(tg, D))
        self.freq_pos_embed = nn.Parameter(torch.zeros(fg, D))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(D)
        self.head_norm = LayerNorm(D)
        self.head = Linear(D, cfg.outputdim)


# ---------------------------------------------------------------------- init

@torch.no_grad()
def init(cfg: UITConfig, generator: torch.Generator) -> UiT:
    """A CPU UiT with the reference init (uit.py:361-376), drawn from
    ``generator`` in the JAX package's order."""
    model = UiT(cfg)
    D, ps = cfg.embed_dim, cfg.patch_size
    kernel, bias = conv2d_torch_default_init(generator, (ps, ps, 1, D))
    model.patch_embed.kernel.copy_(kernel.reshape(ps * ps, D))
    model.patch_embed.bias.copy_(bias)
    g = dict(generator=generator)
    model.cls_token.copy_(1e-6 * torch.randn(model.cls_token.shape, **g))
    model.token_pos_embed.copy_(0.02 * torch.randn(model.token_pos_embed.shape, **g))
    model.time_pos_embed.copy_(0.02 * torch.randn(model.time_pos_embed.shape, **g))
    model.freq_pos_embed.copy_(0.02 * torch.randn(model.freq_pos_embed.shape, **g))
    for blk in model.blocks:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            linear_init(generator, lin)
    linear_init(generator, model.head)
    return model


# ------------------------------------------------------------------- encoder

def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class Cast:
    """A parameter container seen with every tensor cast to ``dtype``, for
    the functions of models/common.py; the casts are differentiable, so
    the gradients reach the float32 parameters."""

    def __init__(self, module: nn.Module, dtype: torch.dtype):
        self._module, self._dtype = module, dtype

    def __getattr__(self, name):
        value = getattr(self._module, name)
        if isinstance(value, torch.Tensor):
            return value.to(self._dtype)
        if isinstance(value, nn.Module):
            return Cast(value, self._dtype)
        return value


def _too_few_frames(cfg: UITConfig, T: int):
    ps = cfg.patch_size
    return ValueError(
        f"input has {T} mel frames but one {ps}x{ps} patch needs at least "
        f"{ps}; feed clips of >= {ps * cfg.frontend.hop_length} samples "
        f"(~{ps * cfg.frontend.hop_length / cfg.frontend.sample_rate:.2f}s)"
    )


def patch_embed(cfg: UITConfig, p: Linear, x: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) mel -> (B, fg, tg, D) patch tokens via reshape+matmul
    (the reference's Conv2d(1, D, 16, stride 16), valid windows only)."""
    B, F, T = x.shape
    ps = cfg.patch_size
    fg, tg = F // ps, T // ps
    if tg < 1:
        raise _too_few_frames(cfg, T)
    x = x[:, : fg * ps, : tg * ps]
    # (B, fg, ps, tg, ps) -> (B, fg, tg, ps, ps): patch rows are the freq
    # axis of the conv kernel (torch's (D, 1, kh, kw) row-major flatten)
    x = x.reshape(B, fg, ps, tg, ps).permute(0, 1, 3, 2, 4).reshape(B, fg, tg, ps * ps)
    return linear(p, x)


def _folded_patch_kernel(cfg: UITConfig, model: UiT, F: int, fg: int, dtype):
    """init_bn's inference affine y = a*m + b folded into the linear patch
    embed: Kf = a . K (per frequency patch), bias_f = b @ K + c.
    Returns (Kf (fg, mel_p, time_p, D), bias_f (fg, D))."""
    ps = cfg.patch_size
    pe = model.patch_embed
    if cfg.init_bn:
        bn = model.init_bn
        a = bn.scale * torch.rsqrt(bn.var + 1e-5)       # (n_mels,)
        b = bn.bias - bn.mean * a
    else:  # GlobalNormer(-10, 20, fac=2): (m + 10) / 40
        a = torch.full((F,), 1.0 / 40.0, dtype=dtype, device=pe.kernel.device)
        b = torch.full((F,), 0.25, dtype=dtype, device=pe.kernel.device)
    K = pe.kernel.reshape(ps, ps, -1)                  # (mel_p, time_p, D)
    a4 = a.reshape(fg, ps)
    b4 = b.reshape(fg, ps)
    Kf = a4[:, :, None, None] * K[None]
    bias_f = torch.einsum("fu,uvd->fd", b4, K) + pe.bias
    return Kf, bias_f


def patch_embed_btf(cfg: UITConfig, model: UiT, x: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) clamped log-mel dB -> (B, fg, tg, D) tokens, with
    init_bn folded into the patch-embed matmul (eval only)."""
    B, T, F = x.shape
    ps = cfg.patch_size
    fg, tg = F // ps, T // ps
    if tg < 1:
        raise _too_few_frames(cfg, T)
    x = x[:, : tg * ps, : fg * ps]
    Kf, bias_f = _folded_patch_kernel(cfg, model, F, fg, x.dtype)
    x5 = x.reshape(B, tg, ps, fg, ps)  # [b, t, v(time-in-patch), f, u(mel-in-patch)]
    tokens = torch.einsum("btvfu,fuvd->btfd", x5, Kf) + bias_f[None, None]
    return tokens.permute(0, 2, 1, 3)                   # (B, fg, tg, D)


def patch_embed_tfb(cfg: UITConfig, model: UiT, x: torch.Tensor) -> torch.Tensor:
    """(T, n_mels, B) clamped log-mel dB -> (B, fg, tg, D) tokens, same
    init_bn fold as patch_embed_btf, consuming the transposed kernel's
    output directly (eval only)."""
    T, F, B = x.shape
    ps = cfg.patch_size
    fg, tg = F // ps, T // ps
    if tg < 1:
        raise _too_few_frames(cfg, T)
    x = x[: tg * ps, : fg * ps, :]
    Kf, bias_f = _folded_patch_kernel(cfg, model, F, fg, x.dtype)
    x5 = x.reshape(tg, ps, fg, ps, B)  # [t, v, f, u, b]
    tokens = torch.einsum("tvfub,fuvd->bftd", x5, Kf)
    return tokens + bias_f[None, :, None]               # (B, fg, tg, D)


def patch_embed_tfb_train(cfg: UITConfig, p: Linear, x: torch.Tensor) -> torch.Tensor:
    """(T, n_mels, B) normalized mel -> (B, fg, tg, D) tokens: the unfolded
    tfb patch embed for training (init_bn ran in train mode on the mel
    already, so its affine cannot be folded); same kernel flattening as
    patch_embed (u = mel-in-patch major)."""
    T, F, B = x.shape
    ps = cfg.patch_size
    fg, tg = F // ps, T // ps
    if tg < 1:
        raise _too_few_frames(cfg, T)
    x = x[: tg * ps, : fg * ps, :]
    K = p.kernel.reshape(ps, ps, -1)                   # (mel_p u, time_p v, D)
    x5 = x.reshape(tg, ps, fg, ps, B)                  # [t, v, f, u, b]
    return torch.einsum("tvfub,uvd->bftd", x5, K) + p.bias


def _drop_patches(generator, x: torch.Tensor, axis: int, frac: float) -> torch.Tensor:
    """Random patch dropout along ``axis``, order kept (uit.py:224)."""
    n = x.shape[axis]
    keep = n - int(n * frac)
    if generator is None:
        raise ValueError("patch dropout in train mode needs a torch.Generator")
    perm = torch.randperm(n, generator=generator, device=generator.device)
    idx = torch.sort(perm[:keep]).values.to(x.device)
    return x.index_select(axis, idx)


def token_validity_mask(cfg: UITConfig, lengths: torch.Tensor, tg: int) -> torch.Tensor:
    """lengths (B,) samples -> (B, fg*tg) bool: which patch tokens lie fully
    inside real (non-padded) audio; the first time patch is always kept."""
    fg = cfg.grid_size[0]
    n_frames = 1 + lengths // cfg.frontend.hop_length
    t_idx = torch.arange(tg, device=lengths.device)
    t_valid = (t_idx + 1) * cfg.patch_stride <= n_frames[:, None]
    t_valid = t_valid | (t_idx == 0)[None, :]
    return t_valid[:, None, :].expand(-1, fg, -1).reshape(lengths.shape[0], -1)


def _prepare_tokens(cfg: UITConfig, model: UiT, x: torch.Tensor, token_mask=None,
                    train: bool = False, generator=None):
    """(B, fg, tg, D) patch tokens -> (B, N, D) block-ready sequence (pos
    embeds, patch dropout, f-major flatten, cls token, input dropout).
    Returns (x, token_mask)."""
    patch_out = cfg.time_patch_out is not None or cfg.freq_patch_out is not None
    if train and token_mask is not None and patch_out:
        raise ValueError(
            "use_length_mask is incompatible with time/freq_patch_out during "
            "training: patch dropout changes the token count after the mask "
            "is built — disable one of the two")
    tg = x.shape[2]
    if tg > model.time_pos_embed.shape[0]:
        raise ValueError(
            f"input spans {tg} time patches but target_length="
            f"{cfg.target_length} provides only "
            f"{model.time_pos_embed.shape[0]} positional embeddings; in "
            f"training, crop clips (chunk_length) or raise target_length"
        )
    x = x + model.time_pos_embed[None, None, :tg, :]
    x = x + model.freq_pos_embed[None, :, None, :]
    if train and cfg.time_patch_out is not None:
        x = _drop_patches(generator, x, 2, cfg.time_patch_out)
    if train and cfg.freq_patch_out is not None:
        x = _drop_patches(generator, x, 1, cfg.freq_patch_out)
    B = x.shape[0]
    x = x.reshape(B, -1, cfg.embed_dim)  # 'b f t c -> b (f t) c'
    if cfg.pooling == "token":
        cls = (model.cls_token + model.token_pos_embed).expand(B, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1)
        if token_mask is not None:
            ones = torch.ones(B, 1, dtype=torch.bool, device=x.device)
            token_mask = torch.cat([ones, token_mask], dim=1)
    x = dropout(generator, x, cfg.drop_rate, deterministic=not train)
    return x.to(compute_dtype(cfg)), token_mask


def block_forward(cfg: UITConfig, blk: Block, x: torch.Tensor, token_mask=None,
                  dpr_i: float = 0.0, train: bool = False, generator=None,
                  mlp_fn: Optional[Callable] = None):
    """One pre-LN transformer block: (B, N, D) -> (B, N, D); in train mode
    with attention/MLP dropout and drop-path at rate ``dpr_i``.

    ``mlp_fn``: optional MLP replacement ``(blk, h) -> (h, aux)``
    (models/moe.py routes experts through it), so every variant runs this
    block's casting, DropPath and LayerScale; with it the return value is
    ``(tokens, aux)``."""
    det = not train
    cdt = compute_dtype(cfg)
    cast = (lambda m: m) if cdt == torch.float32 else (lambda m: Cast(m, cdt))  # noqa: E731
    # LayerNorm in float32, the matmuls in the compute dtype
    h = layer_norm(blk.norm1, x.float(), eps=1e-6).to(cdt)
    h = multihead_attention(cast(blk.attn), h, num_heads=cfg.num_heads,
                            scale=cfg.attn_scale, inner_dim=cfg.inner_dim,
                            causal=cfg.causal, key_mask=token_mask,
                            attn_drop=cfg.attn_drop_rate, proj_drop=cfg.drop_rate,
                            generator=generator, deterministic=det)
    if hasattr(blk, "ls1"):
        h = h * blk.ls1.gamma.to(cdt)
    x = x + drop_path(generator, h, dpr_i, det)
    h = layer_norm(blk.norm2, x.float(), eps=1e-6).to(cdt)
    aux = None
    if mlp_fn is not None:
        h, aux = mlp_fn(blk, h)
        h = h.to(cdt)
    else:
        h = mlp(cast(blk.mlp), h, act=cfg.act, drop=cfg.drop_rate, generator=generator,
                deterministic=det)
    if hasattr(blk, "ls2"):
        h = h * blk.ls2.gamma.to(cdt)
    out = x + drop_path(generator, h, dpr_i, det)
    return out if mlp_fn is None else (out, aux)


def _finish_features(cfg: UITConfig, model: UiT, x: torch.Tensor, token_mask=None,
                     train: bool = False, generator=None):
    """(B, fg, tg, D) patch tokens -> (B, N, D) encoded tokens."""
    x, token_mask = _prepare_tokens(cfg, model, x, token_mask=token_mask,
                                    train=train, generator=generator)
    dpr = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth, dtype=torch.float64).tolist()
    for blk, rate in zip(model.blocks, dpr):
        x = block_forward(cfg, blk, x, token_mask=token_mask, dpr_i=rate,
                          train=train, generator=generator)
    return layer_norm(model.norm, x.float(), eps=1e-6)


def forward_features(cfg: UITConfig, model: UiT, mel: torch.Tensor, token_mask=None,
                     train: bool = False, generator=None):
    """(B, n_mels, T<=target_length) normalized mel -> (B, N, D) tokens."""
    return _finish_features(cfg, model, patch_embed(cfg, model.patch_embed, mel),
                            token_mask=token_mask, train=train, generator=generator)


def forward_head(cfg: UITConfig, model: UiT, x: torch.Tensor, token_mask=None):
    """(B, N, D) tokens -> (B, outputdim) sigmoid probabilities."""

    def head(t):
        # output head LN uses torch default eps=1e-5 (uit.py:358-360)
        return torch.sigmoid(linear(model.head, layer_norm(model.head_norm, t, eps=1e-5)))

    if cfg.pooling == "token":
        return head(x[:, 0])
    if cfg.pooling == "mean":
        if token_mask is not None:
            w = token_mask.to(x.dtype)[:, :, None]
            return head((x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0))
        return head(x.mean(dim=1))
    # 'dm': freq-mean -> per-timestep head+sigmoid -> time-mean
    fg = cfg.grid_size[0]
    B, N, D = x.shape
    probs_t = head(x.reshape(B, fg, N // fg, D).mean(dim=1))  # (B, tg, C)
    if token_mask is not None:
        tmask = token_mask.reshape(B, fg, N // fg)[:, 0, :]
        w = tmask.to(probs_t.dtype)[:, :, None]
        return (probs_t * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    return probs_t.mean(dim=1)


def encode_window(cfg: UITConfig, model: UiT, mel: torch.Tensor, *, train: bool = False,
                  generator=None) -> torch.Tensor:
    """Normalized-input core: (B, n_mels, T) mel dB -> (B, outputdim) probs
    (init_bn with its running statistics, then features and head)."""
    x = apply_init_bn(cfg, model, mel)
    feats = forward_features(cfg, model, x, train=train, generator=generator)
    return forward_head(cfg, model, feats)


def apply_init_bn(cfg: UITConfig, model: UiT, mel: torch.Tensor) -> torch.Tensor:
    if not cfg.init_bn:
        # reference GlobalNormer(-10, 20, fac=2): (x+10)/40 (uit.py:33-41)
        return (mel + 10.0) / 40.0
    return batch_norm_inference(model.init_bn, mel, axis=-2)


def _window_starts(T: int, L: int) -> list[int]:
    """Crop-window start frames: full windows tile from t=0; a short tail
    is REPLACED by the last full window (reference uit.py:474-480)."""
    n_crops = -(-T // L)
    starts = [i * L for i in range(n_crops)]
    if T % L != 0:
        starts[-1] = T - L
    return starts


def chunk_long_mel(cfg: UITConfig, mel: torch.Tensor):
    """(B, F, T>target) -> ((B*n_crops, F, target), n_crops), sample-major."""
    B, F, T = mel.shape
    L = cfg.target_length
    starts = _window_starts(T, L)
    crops = torch.stack([mel[..., s:s + L] for s in starts], dim=1)
    return crops.reshape(B * len(starts), F, L), len(starts)


def chunk_long_mel_btf(cfg: UITConfig, mel: torch.Tensor):
    """(B, T>target, F) -> ((B*n_crops, target, F), n_crops), sample-major."""
    B, T, F = mel.shape
    L = cfg.target_length
    starts = _window_starts(T, L)
    crops = torch.stack([mel[:, s:s + L] for s in starts], dim=1)
    return crops.reshape(B * len(starts), L, F), len(starts)


def chunk_long_mel_tfb(cfg: UITConfig, mel: torch.Tensor):
    """(T>target, F, B) -> ((target, F, n_crops*B), n_crops), crop-major:
    column c*B+b is crop c of sample b."""
    T, F, B = mel.shape
    L = cfg.target_length
    starts = _window_starts(T, L)
    crops = torch.cat([mel[s:s + L] for s in starts], dim=-1)
    return crops, len(starts)


def _reduce_crops(cfg: UITConfig, probs: torch.Tensor, dim: int) -> torch.Tensor:
    return probs.mean(dim=dim) if cfg.eval_avg == "mean" else probs.amax(dim=dim)


def _needs_frontend(cfg: UITConfig):
    return ValueError(f"mel_layout={cfg.mel_layout!r} needs a frontend_fn built with "
                      f"make_frontend_fn(..., layout={cfg.mel_layout!r})")


_INT16_WAV_AUGMENT = ("wav augments expect normalized float32 waveforms; "
                      "train int16 PCM only with wavtransforms: []")


def _forward_train(cfg: UITConfig, model: UiT, wav: torch.Tensor, generator,
                   mixup_lamb, wav_augment, spec_augment, lengths, frontend_fn):
    """The train branches of ``forward`` (uit.py:592-637, 681-759) ->
    (probs, new_state)."""
    if cfg.mel_layout == "btf":
        raise ValueError(
            "mel_layout='btf' is an eval/serving optimization; train with the "
            "default 'bft' layout (BN stat updates cannot be folded into the "
            "patch embed)")
    if cfg.mel_layout == "tfb" and frontend_fn is None:
        raise _needs_frontend(cfg)
    if wav.dtype == torch.int16 and wav_augment is not None:
        # int16 PCM trains bitwise as f32/32768 (the frontends fold the
        # scale); only wav augments need the normalized-f32 convention
        raise ValueError(_INT16_WAV_AUGMENT)
    want = cfg.mel_layout
    if spec_augment is not None and getattr(spec_augment, "layout", "bft") != want:
        raise ValueError(
            f"mel_layout={want!r} training needs spec transforms built with "
            f"parse_spectransforms(..., layout={want!r}); got "
            f"layout={getattr(spec_augment, 'layout', None)!r} — it would mask "
            f"the wrong axes")
    if (wav_augment is not None or spec_augment is not None) and generator is None:
        raise ValueError("wav/spec augments in train mode need a torch.Generator")
    tfb = want == "tfb"
    if frontend_fn is None:
        frontend_fn = lambda w: log_mel_spectrogram(w, cfg.frontend)  # noqa: E731
    if wav_augment is not None:
        wav = wav_augment(generator, wav)
    mel = frontend_fn(wav)  # (T, F, B) tfb, (B, F, T) bft
    if mixup_lamb is not None:
        mel = mixup_tensor(mel, mixup_lamb, batch_axis=-1 if tfb else 0)
    if spec_augment is not None:
        mel = spec_augment(generator, mel)
    new_state = {}
    if cfg.init_bn:
        x, bn = batch_norm_train(model.init_bn, mel, axis=1 if tfb else -2, momentum=0.01)
        new_state = {f"init_bn.{k}": v for k, v in bn.items()}
    else:
        x = (mel + 10.0) / 40.0
    if tfb:
        tokens = patch_embed_tfb_train(cfg, model.patch_embed, x)
        feats = _finish_features(cfg, model, tokens, train=True, generator=generator)
        return forward_head(cfg, model, feats), new_state
    token_mask = None
    if cfg.use_length_mask and lengths is not None:
        if mixup_lamb is not None:
            raise ValueError(
                "use_length_mask is incompatible with mixup: the mask is built "
                "from the primary clip's length, but mixup mixes in a partner "
                "whose audio (and labels) extend past it")
        tg = min(x.shape[-1], cfg.target_length) // cfg.patch_stride
        token_mask = token_validity_mask(cfg, torch.as_tensor(lengths, device=x.device), tg)
    feats = forward_features(cfg, model, x, token_mask=token_mask, train=True,
                             generator=generator)
    return forward_head(cfg, model, feats, token_mask=token_mask), new_state


def forward(cfg: UITConfig, model: UiT, wav: torch.Tensor, *, train: bool = False,
            generator=None, mixup_lamb=None, wav_augment=None, spec_augment=None,
            lengths=None, frontend_fn: Optional[Callable] = None):
    """(B, T_wav) waveform -> (B, outputdim) probabilities; in train mode
    (probs, new_state) (module docstring).

    ``frontend_fn`` swaps in the fused mel kernel (ops.mel.make_frontend_fn);
    mel_layout 'btf'/'tfb' need one of the matching layout. With
    cfg.use_length_mask and ``lengths`` (samples per clip), padded patches
    are excluded from attention and pooling (single-window 'bft' only).
    Train mode takes ``generator`` for its stochastic parts, mixup lambdas
    (mixed in the mel domain against the flipped batch) and the parsed
    wav/spec augments."""
    masked = cfg.use_length_mask and lengths is not None
    if masked and cfg.mel_layout != "bft":
        raise ValueError(
            f"use_length_mask is only implemented on the canonical 'bft' "
            f"layout; the {cfg.mel_layout!r} serving layout would silently "
            f"score padding as audio — drop lengths or use 'bft'"
        )
    if train:
        return _forward_train(cfg, model, wav, generator, mixup_lamb, wav_augment,
                              spec_augment, lengths, frontend_fn)
    if cfg.mel_layout in ("btf", "tfb") and frontend_fn is None:
        raise _needs_frontend(cfg)
    if cfg.mel_layout == "tfb":
        mel = frontend_fn(wav)  # (T, F, B)
        if mel.shape[0] > cfg.target_length:
            crops, n_crops = chunk_long_mel_tfb(cfg, mel)
            feats = _finish_features(cfg, model, patch_embed_tfb(cfg, model, crops))
            probs = forward_head(cfg, model, feats)
            return _reduce_crops(cfg, probs.reshape(n_crops, -1, cfg.outputdim), 0)
        feats = _finish_features(cfg, model, patch_embed_tfb(cfg, model, mel))
        return forward_head(cfg, model, feats)

    if cfg.mel_layout == "btf":
        mel = frontend_fn(wav)  # (B, T, F)
        if mel.shape[1] > cfg.target_length:
            crops, n_crops = chunk_long_mel_btf(cfg, mel)
            feats = _finish_features(cfg, model, patch_embed_btf(cfg, model, crops))
            probs = forward_head(cfg, model, feats)
            return _reduce_crops(cfg, probs.reshape(-1, n_crops, cfg.outputdim), 1)
        feats = _finish_features(cfg, model, patch_embed_btf(cfg, model, mel))
        return forward_head(cfg, model, feats)

    if frontend_fn is None:
        frontend_fn = lambda w: log_mel_spectrogram(w, cfg.frontend)  # noqa: E731
    x = apply_init_bn(cfg, model, frontend_fn(wav))  # (B, n_mels, T)
    T = x.shape[-1]
    if T > cfg.target_length:
        if masked:
            raise ValueError(
                "use_length_mask is not supported on the long-clip crop "
                "path (per-window masks are not built) — score windows "
                "upstream or drop lengths"
            )
        crops, n_crops = chunk_long_mel(cfg, x)
        probs = forward_head(cfg, model, forward_features(cfg, model, crops))
        return _reduce_crops(cfg, probs.reshape(-1, n_crops, cfg.outputdim), 1)
    token_mask = None
    if masked:
        tg = min(T, cfg.target_length) // cfg.patch_stride
        token_mask = token_validity_mask(
            cfg, torch.as_tensor(lengths, device=x.device), tg)
    feats = forward_features(cfg, model, x, token_mask=token_mask)
    return forward_head(cfg, model, feats, token_mask=token_mask)


def forward_framewise(cfg: UITConfig, model: UiT, wav: torch.Tensor, *,
                      frontend_fn: Optional[Callable] = None):
    """Eval-only temporal tagging: (B, T_wav) wav -> (probs (B, S, outputdim),
    times (S, 2) float64 numpy seconds [start, end)).

    Pooling 'dm' gives one segment per time patch (patch_stride frames, 0.16 s
    at defaults), the dm head's per-timestep sigmoid before its time mean;
    'mean'/'token' one segment per crop window (target_length frames), the
    windows of the long-clip forward, the tail window overlapping the one
    before as the crop rule sets it. The mean over S is the forward's
    eval_avg='mean' output."""
    if cfg.mel_layout != "bft":
        raise ValueError("framewise tagging uses the bft layout")
    if frontend_fn is None:
        frontend_fn = lambda w: log_mel_spectrogram(w, cfg.frontend)  # noqa: E731
    x = apply_init_bn(cfg, model, frontend_fn(wav))
    B, F, T = x.shape
    L = min(cfg.target_length, T)
    starts = _window_starts(T, L)
    crops = torch.stack([x[..., s:s + L] for s in starts], dim=1).reshape(B * len(starts), F, L)
    feats = forward_features(cfg, model, crops)  # (B * n, N, D)
    times = framewise_times(cfg, T)
    if cfg.pooling == "dm":
        return forward_head_framewise(cfg, model, feats).reshape(B, -1, cfg.outputdim), times
    return forward_head(cfg, model, feats).reshape(B, len(starts), cfg.outputdim), times


def framewise_times(cfg: UITConfig, n_frames: int) -> np.ndarray:
    """(S, 2) float64 segment extents in seconds for an ``n_frames``-frame
    mel, the host-side companion of forward_framewise. It never passes
    through a tensor: float32 boundaries would move min_overlap
    rasterization at exact-coverage edges."""
    sec_per_frame = cfg.frontend.hop_length / cfg.frontend.sample_rate
    L = min(cfg.target_length, n_frames)
    starts = _window_starts(n_frames, L)
    if cfg.pooling == "dm":
        tg = L // cfg.patch_stride  # time patches per crop window
        return np.array([[(s + j * cfg.patch_stride) * sec_per_frame,
                          (s + (j + 1) * cfg.patch_stride) * sec_per_frame]
                         for s in starts for j in range(tg)], dtype=np.float64)
    return np.array([[s * sec_per_frame, (s + L) * sec_per_frame] for s in starts],
                    dtype=np.float64)


def forward_head_framewise(cfg: UITConfig, model: UiT, x: torch.Tensor) -> torch.Tensor:
    """(B, N, D) tokens -> (B, tg, outputdim) per-time-patch probabilities,
    the 'dm' head before its time mean (whose mean is forward_head's)."""
    if cfg.pooling != "dm":
        raise ValueError("framewise head needs pooling='dm'")
    fg = cfg.grid_size[0]
    B, N, D = x.shape
    h = x.reshape(B, fg, N // fg, D).mean(dim=1)  # (B, tg, D)
    return torch.sigmoid(linear(model.head, layer_norm(model.head_norm, h, eps=1e-5)))


def forward_train_framewise(cfg: UITConfig, model: UiT, wav: torch.Tensor, *,
                            generator=None, wav_augment=None, spec_augment=None,
                            frontend_fn: Optional[Callable] = None):
    """Train-mode framewise forward for SED: (B, T_wav) single-window clips
    -> ((B, tg, outputdim) per-time-patch probabilities, new_state).

    The train path of ``forward`` ('bft': wav augments, mel, spec augments,
    init_bn on batch statistics, features with dropout and drop-path)
    keeping the dm head's per-segment probabilities for a strong-label
    loss. No mixup (it has no per-segment target), and a wav augment must
    preserve time (a shift would move the audio off its targets)."""
    if cfg.mel_layout != "bft":
        raise ValueError("framewise training uses the bft layout")
    if wav.dtype == torch.int16 and wav_augment is not None:
        raise ValueError(_INT16_WAV_AUGMENT)
    if spec_augment is not None and getattr(spec_augment, "layout", "bft") != "bft":
        raise ValueError("framewise training needs spec transforms built with "
                         "parse_spectransforms(..., layout='bft')")
    if (wav_augment is not None or spec_augment is not None) and generator is None:
        raise ValueError("wav/spec augments in train mode need a torch.Generator")
    if frontend_fn is None:
        frontend_fn = lambda w: log_mel_spectrogram(w, cfg.frontend)  # noqa: E731
    if wav_augment is not None:
        wav = wav_augment(generator, wav)
    mel = frontend_fn(wav)  # (B, n_mels, T)
    if spec_augment is not None:
        mel = spec_augment(generator, mel)
    new_state = {}
    if cfg.init_bn:
        x, bn = batch_norm_train(model.init_bn, mel, axis=-2, momentum=0.01)
        new_state = {f"init_bn.{k}": v for k, v in bn.items()}
    else:
        x = (mel + 10.0) / 40.0
    if x.shape[-1] > cfg.target_length:
        raise ValueError("framewise training takes single-window clips of at most "
                         f"target_length={cfg.target_length} frames")
    feats = forward_features(cfg, model, x, train=True, generator=generator)
    return forward_head_framewise(cfg, model, feats), new_state


# ------------------------------------------------------------------ factories

def _factory(name: str, **base):
    def make(**overrides) -> UITConfig:
        kw = dict(base)
        kw.update(overrides)
        return UITConfig(**kw)

    make.__name__ = name
    return make


# Reference factory configs (uit.py:514-635). All: D=128, 2 heads, mlp x3,
# mean pooling, init_bn, patch 16/16.
_H128 = dict(patch_size=16, embed_dim=128, num_heads=2, mlp_ratio=3.0,
             pooling="mean", init_bn=True, drop_path_rate=0.0)

uit_xs = _factory("uit_xs", depth=12, act="relu", attention_type="BNeckAttention", **_H128)
uit_xxs = _factory("uit_xxs", depth=6, act="relu", attention_type="BNeckAttention", **_H128)
uit_xxxs = _factory("uit_xxxs", depth=4, act="relu", attention_type="BNeckAttention", **_H128)
audio_transformer_h128_d4_m3 = _factory("audio_transformer_h128_d4_m3", depth=4, **_H128)
audio_transformer_h128_d4_m3_relu = _factory(
    "audio_transformer_h128_d4_m3_relu", depth=4, act="relu", **_H128)
audio_transformer_h128_d6_m3 = _factory("audio_transformer_h128_d6_m3", depth=6, **_H128)
audio_transformer_h128_d6_m3_relu = _factory(
    "audio_transformer_h128_d6_m3_relu", depth=6, act="relu", **_H128)

# Local pretrained checkpoints: ``checkpoints/<name>.npz`` in the repo (the
# port never downloads). The factory kwargs are the published heads.
CHECKPOINT_DIR = Path(__file__).resolve().parent.parent.parent / "checkpoints"
PRETRAINED_CHECKPOINTS = {
    name: {"factory": factory, "model_kwargs": dict(outputdim=537, target_length=102),
           "path": CHECKPOINT_DIR / f"{name}.npz"}
    for name, factory in (("uit_xs", uit_xs), ("uit_xxs", uit_xxs), ("uit_xxxs", uit_xxxs))
}
