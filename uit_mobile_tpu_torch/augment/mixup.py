"""Mixup, counterpart of ``uit_mobile_tpu/augment/mixup.py``.

Per-sample Beta(alpha, alpha) lambdas mix the MEL spectrogram against the
batch-flipped one inside the model's train forward, and the targets with
the same lambdas; lengths combine by elementwise max with the flipped
batch. The lambdas are drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch


def sample_mixup_lambdas(generator: torch.Generator, batch_size: int,
                         alpha: float) -> torch.Tensor:
    """(batch_size,) Beta(alpha, alpha) coefficients on the generator's
    device (the first component of a two-way Dirichlet draw)."""
    conc = torch.full((batch_size, 2), float(alpha), device=generator.device)
    return torch._sample_dirichlet(conc, generator=generator)[:, 0]


def mixup_tensor(x: torch.Tensor, lamb: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """mixed = flip(x) * lamb + x * (1 - lamb), lamb broadcast from the
    batch axis (0 for the 'bft' mel, waves and targets; -1 for the 'tfb'
    mel whose batch is the last axis)."""
    batch_axis = batch_axis % x.dim()
    shape = [1] * x.dim()
    shape[batch_axis] = -1
    lam = lamb.reshape(shape)
    return x.flip(batch_axis) * lam + x * (1.0 - lam)


def mixup_targets(y: torch.Tensor, lamb: torch.Tensor) -> torch.Tensor:
    return mixup_tensor(y, lamb)


def mixup_lengths(lengths: torch.Tensor) -> torch.Tensor:
    return torch.maximum(lengths, lengths.flip(0))
