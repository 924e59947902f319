"""Deterministic synthetic keyword world, counterpart of
``uit_mobile_tpu/data/synthworld.py``.

537 classes: each keyword index (527-536) is a pure tone at a fixed
frequency, and the "AudioSet" filler is colored noise labeled class 0.
``synth_clip`` makes clips in numpy; ``build_world`` writes the HDF5 + TSV
splits the Trainer reads (h5py and pandas are imported only there).

The eventful variant: 20 "AudioSet event" tones (classes 1-20) at
frequencies between the keyword tones, each a short burst at a random
place inside a long clip, so where a crop lands decides what it holds
(the world the offline-PSL crop grid is sensitive to).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# keyword class -> tone frequency, 300 Hz .. ~4.5 kHz
KW_FREQS = {527 + i: 300.0 * (1.35 ** i) for i in range(10)}


def synth_clip(rng: np.random.Generator, label: int, sr: int = 16000) -> np.ndarray:
    """One 1 s int16 clip: a noisy pure tone for keyword labels, colored
    noise for the class-0 filler."""
    t = np.arange(sr) / sr
    if label in KW_FREQS:
        w = rng.uniform(0.2, 0.8) * np.sin(2 * np.pi * KW_FREQS[label] * t
                                           + rng.uniform(0, 2 * np.pi))
        w += rng.standard_normal(sr) * 0.02
    else:
        w = rng.standard_normal(sr) * rng.uniform(0.05, 0.3)
    return (np.clip(w, -1, 1) * 32000).astype(np.int16)


def synth_labels(rng: np.random.Generator, n: int, kws: bool) -> list[int]:
    """n labels: uniform keyword classes for the KWS half, 0 otherwise."""
    return [int(rng.choice(list(KW_FREQS))) if kws else 0 for _ in range(n)]


# "AudioSet event" class -> tone frequency, interleaved with the keyword tones
AS_FREQS = {1 + i: 260.0 * (1.21 ** i) for i in range(20)}


def synth_eventful_clip(rng: np.random.Generator, labels, sr: int = 16000,
                        seconds: float = 10.0, events: list | None = None) -> np.ndarray:
    """One long int16 clip: low background noise plus one Hann-windowed tone
    burst (~0.8-1.5 s, at most the clip) per label at a random place; a
    given ``events`` list receives each burst as (label, onset_s,
    offset_s), the strong labels of the clip."""
    n = int(sr * seconds)
    w = rng.standard_normal(n) * rng.uniform(0.02, 0.08)
    for lab in labels:
        f = AS_FREQS[int(lab)]
        dur = min(int(sr * rng.uniform(0.8, 1.5)), n)
        start = int(rng.integers(0, max(1, n - dur)))
        t = np.arange(dur) / sr
        tone = rng.uniform(0.3, 0.8) * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        w[start:start + dur] += tone * np.hanning(dur)
        if events is not None:
            events.append((int(lab), start / sr, (start + dur) / sr))
    return (np.clip(w, -1, 1) * 32000).astype(np.int16)


def eventful_labels(rng: np.random.Generator) -> list[int]:
    """1-2 distinct event classes of one eventful clip."""
    k = int(rng.integers(1, 3))
    return [int(x) for x in rng.choice(list(AS_FREQS), size=k, replace=False)]


def make_eventful_split(root: Path, name: str, n: int, rng: np.random.Generator,
                        seconds: float = 10.0) -> str:
    """One HDF5 + TSV split of long multi-event clips (';'-joined labels);
    returns the TSV path."""
    import h5py
    import pandas as pd

    root = Path(root)
    h5 = root / f"{name}.h5"
    rows = []
    with h5py.File(h5, "w") as f:
        for i in range(n):
            labels = eventful_labels(rng)
            f[f"{name}_{i}.wav"] = synth_eventful_clip(rng, labels, seconds=seconds)
            rows.append((f"{name}_{i}.wav", ";".join(str(x) for x in labels), str(h5)))
    tsv = root / f"{name}.tsv"
    pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
        tsv, sep="\t", index=False)
    return str(tsv)


def build_eventful_world(outdir, seed: int = 0, n_train: int = 128, n_eval: int = 48,
                         seconds: float = 10.0) -> dict:
    """The long-clip variant of ``build_world``: the AudioSet halves are
    multi-event clips of ``seconds`` (crop position matters), the keyword
    halves the 1 s tones. Deterministic in its arguments, as in the JAX
    package."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    return {
        "audioset_train_data": make_eventful_split(outdir, "as_train", n_train, rng, seconds),
        "audioset_eval_data": make_eventful_split(outdir, "as_eval", n_eval, rng, seconds),
        "kws_train_data": make_split(outdir, "kws_train", n_train, rng, kws=True),
        "kws_test_data": make_split(outdir, "kws_eval", n_eval, rng, kws=True),
    }


def make_split(root: Path, name: str, n: int, rng: np.random.Generator, kws: bool) -> str:
    """Write one HDF5 + TSV split; returns the TSV path."""
    import h5py
    import pandas as pd

    root = Path(root)
    h5 = root / f"{name}.h5"
    rows = []
    with h5py.File(h5, "w") as f:
        for i in range(n):
            label = synth_labels(rng, 1, kws)[0]
            f[f"{name}_{i}.wav"] = synth_clip(rng, label)
            rows.append((f"{name}_{i}.wav", str(label), str(h5)))
    tsv = root / f"{name}.tsv"
    pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
        tsv, sep="\t", index=False)
    return str(tsv)


def build_world(outdir, seed: int = 0, n_train: int = 256, n_eval: int = 64) -> dict:
    """The 4-split world -> the config keys the Trainer consumes.
    Deterministic in (seed, n_train, n_eval), as in the JAX package."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    return {
        "audioset_train_data": make_split(outdir, "as_train", n_train, rng, kws=False),
        "audioset_eval_data": make_split(outdir, "as_eval", n_eval, rng, kws=False),
        "kws_train_data": make_split(outdir, "kws_train", n_train, rng, kws=True),
        "kws_test_data": make_split(outdir, "kws_eval", n_eval, rng, kws=True),
    }
