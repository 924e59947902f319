"""MobileNetV2 audio tagger, counterpart of ``uit_mobile_tpu/models/mobilenetv2.py``.

The PSL distillation teacher (frozen, eval mode) and a trainable baseline
through the same train step as the UiT students. Same architecture as the
JAX package: the inverted-residual table, a stride-2 3x3 stem over the
(freq, time) log-mel plane, the freq-mean "dm" head (per-timestep
classifier -> sigmoid -> time mean) and dropout 0.3 before the classifier.

Layout: NCHW ``conv2d`` with ``groups`` (depthwise = ``groups=hidden``) and
padding ``(k-1)//2``; the mel (B, F, T) enters as (B, 1, F, T), so H is the
freq axis and the head's freq mean is over dim 2. Conv kernels are OIHW;
the JAX package keeps HWIO, and ``ckpt/convert.py`` permutes between them.
Parameter names mirror the JAX pytree (``features.3.layers.1.conv.kernel``,
``features.3.layers.1.bn.mean`` as a buffer). Train mode returns
``(probs, new_state)`` with every BN's running statistics (momentum 0.1)
keyed by buffer name, as ``models.uit.forward`` does.

``compute_dtype='bfloat16'`` rounds each conv's input and kernel to
bfloat16 and convolves them in float32: the products of two bfloat16
values are exact in float32, so this is the JAX conv with
``preferred_element_type=float32`` (bfloat16 operands, float32
accumulation) up to the order of the sums. BN, ReLU6, the residual adds,
the classifier and the sigmoid stay float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..augment.mixup import mixup_tensor
from ..frontend import FrontendConfig, log_mel_spectrogram
from .common import (BatchNorm, Linear, batch_norm_inference, batch_norm_train, dropout,
                     linear)

BN_MOMENTUM = 0.1  # the running statistics' step toward a train batch's

# (expand_ratio t, out_channels c, repeats n, stride s), reference table
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


@dataclasses.dataclass(frozen=True)
class MobileNetV2Config:
    outputdim: int = 527
    width_mult: float = 1.0
    input_channel: int = 32
    last_channel: int = 1280
    dropout: float = 0.3
    n_mels: int = 64
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.compute_dtype!r}")


def _c(ch, width_mult):
    return int(ch * width_mult)


def layer_specs(cfg: MobileNetV2Config):
    """One entry per torch ``features[i]``:
    ('convbnrelu', c_in, c_out, k, stride, groups) or
    ('invres', c_in, c_out, stride, expand_ratio)."""
    specs = []
    in_ch = _c(cfg.input_channel, cfg.width_mult)
    specs.append(("convbnrelu", 1, in_ch, 3, 2, 1))
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        out_ch = _c(c, cfg.width_mult)
        for i in range(n):
            specs.append(("invres", in_ch, out_ch, s if i == 0 else 1, t))
            in_ch = out_ch
    last = _c(cfg.last_channel, cfg.width_mult) if cfg.width_mult > 1.0 else cfg.last_channel
    specs.append(("convbnrelu", in_ch, last, 1, 1, 1))
    return specs


# ------------------------------------------------------------------- modules

class Conv(nn.Module):
    """{'kernel': (c_out, c_in // groups, k, k)} (OIHW, no bias)."""

    def __init__(self, c_in: int, c_out: int, k: int, groups: int = 1):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(c_out, c_in // groups, k, k))


class ConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, groups: int = 1):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, groups)
        self.bn = BatchNorm(c_out)


class InvertedResidual(nn.Module):
    def __init__(self, c_in: int, c_out: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(c_in * expand_ratio))
        layers = [ConvBN(c_in, hidden, 1)] if expand_ratio != 1 else []
        layers += [ConvBN(hidden, hidden, 3, groups=hidden), ConvBN(hidden, c_out, 1)]
        self.layers = nn.ModuleList(layers)


class MobileNetV2(nn.Module):
    """Parameter container of one MobileNetV2 (zeros; ``init`` fills it).
    The forward is the function ``forward(cfg, model, wav)`` below."""

    def __init__(self, cfg: MobileNetV2Config):
        super().__init__()
        self.cfg = cfg
        feats = []
        for spec in layer_specs(cfg):
            if spec[0] == "convbnrelu":
                _, c_in, c_out, k, _, groups = spec
                feats.append(ConvBN(c_in, c_out, k, groups))
            else:
                _, c_in, c_out, _, t = spec
                feats.append(InvertedResidual(c_in, c_out, t))
        self.features = nn.ModuleList(feats)
        self.classifier = Linear(layer_specs(cfg)[-1][2], cfg.outputdim)


@torch.no_grad()
def init(cfg: MobileNetV2Config, generator: torch.Generator) -> MobileNetV2:
    """A CPU MobileNetV2 with the JAX package's init (mobilenetv2.py:81-124):
    conv kernels U[-b, b] with b = 1/sqrt(fan_in), BN at identity, the
    classifier U[-1/sqrt(last), 1/sqrt(last)]."""
    model = MobileNetV2(cfg)
    for mod in model.modules():
        if isinstance(mod, Conv):
            fan_in = mod.kernel[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            mod.kernel.uniform_(-bound, bound, generator=generator)
    bound = 1.0 / math.sqrt(model.classifier.kernel.shape[0])
    model.classifier.kernel.uniform_(-bound, bound, generator=generator)
    model.classifier.bias.uniform_(-bound, bound, generator=generator)
    return model


def calibrate_bn(cfg: MobileNetV2Config, model: MobileNetV2, wav: torch.Tensor,
                 frontend_fn=None) -> MobileNetV2:
    """Set every BN's running statistics to those of ``wav``'s batch as a
    train forward sees them (new = old + 0.1 (batch - old), solved for
    batch), each variance floored at the mean of its BN's -> ``model``.

    At ``init`` every BN is the identity and each conv shrinks the
    activations, so the probabilities are sigmoid(classifier bias) whatever
    the input. Calibrated on a batch of clips, a teacher with random weights
    scores what it hears. The floor keeps a near-constant channel from
    amplifying roundings: without it the calibrated network is chaotic
    (1e-3 dB on the mel moves a probability by 1e-3)."""
    with torch.no_grad():
        _, new_state = forward(cfg, model, wav, train=True, frontend_fn=frontend_fn)
        buffers = dict(model.named_buffers())
        for name, value in new_state.items():
            buf = buffers[name]
            buf.add_(value - buf, alpha=1.0 / BN_MOMENTUM)
            if name.endswith(".var"):
                buf.clamp_(min=buf.mean().item())
    return model


# -------------------------------------------------------------------- forward

def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _conv_bn_relu6(p: ConvBN, x, stride: int, groups: int, name: str, new_state: dict,
                   train: bool, momentum: float = BN_MOMENTUM, relu: bool = True,
                   bf16: bool = False):
    k = p.conv.kernel.shape[-1]
    kernel = p.conv.kernel
    if bf16:
        x, kernel = _bf16_rounded(x), _bf16_rounded(kernel)
    x = F.conv2d(x, kernel, stride=stride, padding=(k - 1) // 2, groups=groups)
    if train:
        x, bn = batch_norm_train(p.bn, x, axis=1, momentum=momentum)
        new_state.update({f"{name}.bn.{k}": v for k, v in bn.items()})
    else:
        x = batch_norm_inference(p.bn, x, axis=1)
    return torch.clamp(x, 0.0, 6.0) if relu else x


def _invres_forward(spec, p: InvertedResidual, x, name: str, new_state: dict, train: bool,
                    bf16: bool):
    _, c_in, c_out, stride, t = spec
    hidden = int(round(c_in * t))
    h = x
    layers = list(p.layers)
    i = 0
    if t != 1:
        h = _conv_bn_relu6(layers[0], h, 1, 1, f"{name}.layers.0", new_state, train, bf16=bf16)
        i = 1
    h = _conv_bn_relu6(layers[i], h, stride, hidden, f"{name}.layers.{i}", new_state, train,
                       bf16=bf16)
    h = _conv_bn_relu6(layers[i + 1], h, 1, 1, f"{name}.layers.{i + 1}", new_state, train,
                       relu=False, bf16=bf16)
    return x + h if stride == 1 and c_in == c_out else h


def features_forward(cfg: MobileNetV2Config, model: MobileNetV2, mel: torch.Tensor,
                     train: bool = False):
    """(B, n_mels, T) log-mel -> ((B, T', last_channel) freq-pooled
    features, new_state) (new_state empty in eval mode)."""
    x = mel[:, None]  # (B, 1, F, T)
    new_state: dict = {}
    bf16 = cfg.compute_dtype == "bfloat16"
    for i, (spec, p) in enumerate(zip(layer_specs(cfg), model.features)):
        name = f"features.{i}"
        if spec[0] == "convbnrelu":
            _, _, _, _, stride, groups = spec
            x = _conv_bn_relu6(p, x, stride, groups, name, new_state, train, bf16=bf16)
        else:
            x = _invres_forward(spec, p, x, name, new_state, train, bf16)
    # AdaptiveAvgPool2d((1, None)): average the freq axis, keep time
    return x.mean(dim=2).transpose(1, 2), new_state


def forward(cfg: MobileNetV2Config, model: MobileNetV2, wav: torch.Tensor, *,
            train: bool = False, generator=None, wav_augment=None, spec_augment=None,
            mixup_lamb=None, frontend_fn=None):
    """(B, T_wav) waveform -> (B, outputdim) probs ('dm' head); in train
    mode (probs, new_state). Mixup and the augments follow
    ``models.uit.forward``'s 'bft' rules."""
    if train and wav.dtype == torch.int16 and wav_augment is not None:
        raise ValueError("wav augments expect normalized float32 waveforms; "
                         "train int16 PCM only with wavtransforms: []")
    if train and (wav_augment is not None or spec_augment is not None) and generator is None:
        raise ValueError("wav/spec augments in train mode need a torch.Generator")
    if frontend_fn is None:
        frontend_fn = lambda w: log_mel_spectrogram(w, cfg.frontend)  # noqa: E731
    if train and wav_augment is not None:
        wav = wav_augment(generator, wav)
    mel = frontend_fn(wav)  # (B, n_mels, T)
    if train and mixup_lamb is not None:
        mel = mixup_tensor(mel, mixup_lamb)
    if train and spec_augment is not None:
        mel = spec_augment(generator, mel)
    feats, new_state = features_forward(cfg, model, mel, train=train)
    # dropout 0.3 before the classifier; like the JAX forward (rng=None), a
    # train forward without a generator leaves it out
    feats = dropout(generator, feats, cfg.dropout, deterministic=not train or generator is None)
    probs = torch.sigmoid(linear(model.classifier, feats)).mean(dim=1)
    if train:
        return probs, new_state
    return probs


def total_time_stride(cfg: MobileNetV2Config) -> int:
    """Cumulative time downsampling of the feature stack (32 for the
    standard table)."""
    stride = 1
    for spec in layer_specs(cfg):
        stride *= spec[4] if spec[0] == "convbnrelu" else spec[3]
    return stride


def forward_framewise(cfg: MobileNetV2Config, model: MobileNetV2, wav: torch.Tensor, *,
                      frontend_fn=None):
    """Eval-only temporal tagging: (B, T_wav) -> (probs (B, S, C), times
    (S, 2) float64 seconds). The network is fully convolutional in time, so
    the per-timestep classifier probabilities are the segments: one per
    feature step, total_time_stride mel frames long (0.32 s at defaults)."""
    if frontend_fn is None:
        frontend_fn = lambda w: log_mel_spectrogram(w, cfg.frontend)  # noqa: E731
    feats, _ = features_forward(cfg, model, frontend_fn(wav))
    probs = torch.sigmoid(linear(model.classifier, feats))  # (B, S, C)
    sec = total_time_stride(cfg) * cfg.frontend.hop_length / cfg.frontend.sample_rate
    times = np.array([[j * sec, (j + 1) * sec] for j in range(probs.shape[1])],
                     dtype=np.float64)
    return probs, times


def mobilenetv2(**kwargs) -> MobileNetV2Config:
    """Factory under the reference registry name ``MobileNetV2``."""
    return MobileNetV2Config(**kwargs)
