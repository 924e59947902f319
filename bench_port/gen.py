"""The benchmark's inputs, made from ``--seed`` on the device in a few large
calls: audio, multi-hot targets and model weights. The same seed gives
the same inputs on one device; the traffic files say how much of each a
mix takes.

``audio`` is a seeded sound scene: a noise floor with tonal events
(harmonic stacks under a Hann envelope) at random times, pitches and
levels, as int16 PCM, so that the mel's dynamic range and the per-clip dB
clamp see loud and quiet frames alike.
"""

from __future__ import annotations

import math

import torch

SR = 16000


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named use (``stream``) of ``seed``,
    so that adding a use never moves another's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7919) % (2 ** 63 - 1))
    return g


def audio(seed: int, n: int, device, stream: int = 0, events_per_s: float = 3.0,
          noise: float = 0.01) -> torch.Tensor:
    """(n,) int16 PCM of a seeded scene (module docstring)."""
    g = generator(seed, device, stream)
    wav = noise * torch.randn(n, generator=g, device=device)
    k = max(1, int(n / SR * events_per_s))
    u = torch.rand(k, 5, generator=g, device=device).double().cpu().tolist()
    for start_u, dur_u, f0_u, amp_u, harm_u in u:
        dur = int(SR * (0.1 + 0.9 * dur_u))
        start = int(start_u * max(1, n - dur))
        f0 = 100.0 * math.exp(f0_u * math.log(30.0))       # 100 Hz .. 3 kHz
        amp = 0.02 * math.exp(amp_u * math.log(20.0))      # 0.02 .. 0.4
        t = torch.arange(dur, device=device, dtype=torch.float32) / SR
        env = torch.hann_window(dur, periodic=False, device=device)
        tone = sum(torch.sin(2 * math.pi * f0 * h * t) / h
                   for h in range(1, 2 + int(4 * harm_u)) if f0 * h < SR / 2)
        wav[start:start + dur] += amp * env * tone
    return torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(torch.int16)


def multihot(seed: int, rows: int, classes: int, device, stream: int = 1,
             per_row: int = 3) -> torch.Tensor:
    """(rows, classes) float32 targets, 1 to ``per_row`` classes a row."""
    g = generator(seed, device, stream)
    scores = torch.rand(rows, classes, generator=g, device=device)
    n = 1 + (torch.rand(rows, 1, generator=g, device=device) * per_row).long()
    rank = scores.argsort(dim=1).argsort(dim=1)
    return (rank < n).float()


def weights(specs: list, seed: int, device, stream: int = 2) -> dict:
    """{name: float32 tensor} for ``specs``, a list of (name, shape, kind,
    scale): one normal draw for all of them, cut and shaped by kind:
    'normal' scale * N; 'one' 1 + scale * N; 'var' exp(scale * N) times
    the entry's fifth field, where given (a positive variance)."""
    g = generator(seed, device, stream)
    sizes = [math.prod(s[1]) for s in specs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for spec, size in zip(specs, sizes):
        name, shape, kind, scale = spec[:4]
        x = flat[at:at + size].reshape(shape)
        at += size
        if kind == "normal":
            out[name] = scale * x
        elif kind == "one":
            out[name] = 1.0 + scale * x
        elif kind == "var":
            out[name] = spec[4] * torch.exp(scale * x)
        else:
            raise ValueError(f"unknown weight kind {kind!r}")
    return out
