"""Inference CLI: wav files in, ranked label probabilities out.

Same output as ``uit_mobile_tpu.cli.infer`` (``Keyword:`` prefix for
indices above 526), on the card by default:

    python -m uit_mobile_tpu_torch.cli.infer samples/*.wav -m ckpt.npz -k 3
    python -m uit_mobile_tpu_torch.cli.infer samples/*.wav -m ckpt.npz --kernel
    python -m uit_mobile_tpu_torch.cli.infer clip.wav -m a.npz,b.npz --timestamps
    python -m uit_mobile_tpu_torch.cli.infer clip.wav -m ckpt.npz --events --device cpu

Without ``--kernel`` the model runs the rfft reference frontend, as the JAX
CLI does; ``--kernel`` runs the fused mel kernel at exact precision.
``--timestamps`` ranks labels per time segment (per crop window; per
0.16 s patch for dm pooling), ``--events`` extracts (label, onset, offset)
events from those segments. A comma-joined ``-m`` is an ensemble: the mean
of its members' probabilities.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .. import models
from ..data import read_wav
from ..evaluate.events import extract_events
from ..ops.pipeline import make_forward_fn, make_framewise_fn
from .common import load_label_map, resolve_model


def run_inference(cfg, model, wavs: list[np.ndarray], batched: bool = False,
                  kernel: bool = False) -> list[np.ndarray]:
    """Score (T,) float32 waveforms -> list of (outputdim,) probs. Non-batched
    mode scores each clip at its exact length; ``batched`` zero-pads all to
    the longest and runs one batch. ``model`` may be a list (an ensemble)."""
    fwd = make_forward_fn(cfg, model, use_kernel=kernel, precision="exact")
    if batched and len(wavs) > 1:
        batch = np.zeros((len(wavs), max(w.shape[-1] for w in wavs)), dtype=np.float32)
        for i, w in enumerate(wavs):
            batch[i, : w.shape[-1]] = w
        return list(fwd(batch).cpu().numpy())
    return [fwd(np.ascontiguousarray(w[None, :]))[0].cpu().numpy() for w in wavs]


def print_framewise(cfg, model, wavpaths, wavs, fmt, args) -> None:
    """Per clip, the top-k labels of every time segment (--timestamps) or
    the events extracted from the segments (--events)."""
    fwd = make_framewise_fn(cfg, model, use_kernel=args.kernel, precision="exact")
    for wavpath, wave in zip(wavpaths, wavs):
        print(f"===== {str(wavpath):^20} =====")
        probs, times = fwd(np.ascontiguousarray(wave[None, :]))
        probs = probs[0].cpu().numpy()
        if args.events:
            events = extract_events(times, probs, threshold=args.event_threshold,
                                    median_kernel=args.median_kernel,
                                    min_duration=args.min_duration, merge_gap=args.merge_gap)
            if not events:
                print(f"(no events above threshold {args.event_threshold})")
            for cls, on, off in events:
                print(f"[{on:6.2f}-{off:6.2f}s] {fmt(cls)}")
            continue
        for (t0, t1), seg in zip(times, probs):
            top = np.argsort(seg)[::-1][: args.topk]
            print(f"[{t0:6.2f}-{t1:6.2f}s] " + "  ".join(f"{fmt(i)} {seg[i]:.3f}" for i in top))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="uit-infer-torch", description="UiT audio tagging + keyword spotting")
    parser.add_argument("input_wav", type=Path, nargs="+")
    parser.add_argument(
        "-m", "--model", default="uit_xs",
        help=f"local pretrained name [{', '.join(models.PRETRAINED_CHECKPOINTS)}], "
             "a .npz checkpoint, an experiment directory, or several joined by commas "
             "(an ensemble)")
    parser.add_argument("-k", "--topk", type=int, default=3)
    parser.add_argument("--batched", action="store_true",
                        help="score all wavs in one padded batch")
    parser.add_argument("--labels", type=Path, default=None,
                        help="label index CSV (default: bundled 537-class map)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--kernel", action="store_true",
                        help="run the fused mel kernel path (exact precision)")
    parser.add_argument("--timestamps", action="store_true",
                        help="temporal tagging: top-k per time segment (per crop window; "
                             "per 0.16 s patch for dm-pooling models)")
    parser.add_argument("--events", action="store_true",
                        help="sound-event detection: (label, onset, offset) events from the "
                             "framewise probabilities (median filter, threshold, run merging)")
    parser.add_argument("--event-threshold", type=float, default=0.5)
    parser.add_argument("--median-kernel", type=int, default=3,
                        help="odd median-filter width in segments (--events)")
    parser.add_argument("--min-duration", type=float, default=0.0)
    parser.add_argument("--merge-gap", type=float, default=0.0)
    args = parser.parse_args(argv)

    label_maps = load_label_map(args.labels)
    cfg, model = resolve_model(args.model, device=args.device)
    if cfg.outputdim != len(label_maps):
        # custom-head checkpoint: index names instead of the AudioSet table
        label_maps = {i: f"class_{i}" for i in range(cfg.outputdim)}

    wavs = []
    for wavpath in args.input_wav:
        wave, sr = read_wav(wavpath)
        if sr != 16000:
            raise ValueError(
                f"{wavpath}: models are trained on 16khz, please resample "
                f"your input to 16khz (got {sr} Hz)")
        wavs.append(wave[0])

    def fmt(lab_idx):
        name = label_maps[int(lab_idx)]
        return f"Keyword: {name}" if lab_idx > 526 else name

    if args.timestamps or args.events:
        print_framewise(cfg, model, args.input_wav, wavs, fmt, args)
        return 0
    outputs = run_inference(cfg, model, wavs, batched=args.batched, kernel=args.kernel)
    for wavpath, output in zip(args.input_wav, outputs):
        print(f"===== {str(wavpath):^20} =====")
        top = np.argsort(output)[::-1][: args.topk]
        for lab_idx in top:
            print(f"{fmt(lab_idx):<30} {output[lab_idx]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
