"""Streaming CLI: real-time sliding-window tagging + online sound events.

    # simulate a live stream from wav files (chunked at the hop size)
    python -m uit_mobile_tpu_torch.cli.stream long_clip.wav -m CKPT --events

    # a live stream: raw mono s16le 16 kHz PCM on stdin
    arecord -f S16_LE -r 16000 -c 1 | python -m uit_mobile_tpu_torch.cli.stream --raw -m CKPT

Emits one JSON line per emission:
    {"kind": "window",  "t": 1.25, "top": [["Water", 0.91], ...]}
    {"kind": "trigger", "t": 1.25, "keyword": "on", "prob": 0.97}
    {"kind": "event",   "label": "Water", "onset": 0.5, "offset": 2.25, "peak": 0.93}

Windows re-score every ``--hop`` seconds over the model's 1 s receptive
window (serve.MultiStreamTagger, int16 ring, on the card unless ``--device
cpu``); keyword triggers use the GSC operating threshold with a refractory
period; ``--events`` adds the online hysteresis event detector
(serve.OnlineEventDetector), emitting events as they close (the end of the
stream flushes the rest).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from .common import load_label_map, resolve_model


def main(argv=None):
    parser = argparse.ArgumentParser(prog="uit-stream-torch")
    parser.add_argument("input_wav", type=Path, nargs="*",
                        help="wav files to stream one after another (omit with --raw)")
    parser.add_argument("-m", "--model", default="uit_xs")
    parser.add_argument("-k", "--topk", type=int, default=3)
    parser.add_argument("--raw", action="store_true",
                        help="read raw mono s16le 16 kHz PCM from stdin")
    parser.add_argument("--hop", type=float, default=0.25, help="re-score cadence in seconds")
    parser.add_argument("--threshold", type=float, default=0.2,
                        help="keyword trigger threshold (GSC operating point)")
    parser.add_argument("--refractory", type=float, default=1.0)
    parser.add_argument("--windows", action="store_true",
                        help="also emit every window's top-k (chatty)")
    parser.add_argument("--events", action="store_true",
                        help="online sound-event detection over the AudioSet classes "
                             "(hysteresis on/off thresholds + hang time)")
    parser.add_argument("--on-threshold", type=float, default=0.5)
    parser.add_argument("--off-threshold", type=float, default=0.3)
    parser.add_argument("--thresholds", default=None, metavar="JSON",
                        help="per-class operating-point file from `cli.evaluate strong "
                             "--thresholds-out`: each class opens at its own tuned "
                             "threshold (--off-threshold clamps to it per class); "
                             "overrides --on-threshold")
    parser.add_argument("--hang", type=float, default=0.5,
                        help="seconds below off-threshold before an event closes")
    parser.add_argument("--min-duration", type=float, default=0.0)
    parser.add_argument("--track-classes", default=None, metavar="I,J,...",
                        help="comma-separated class indices the online event detector "
                             "watches (default: all AudioSet classes)")
    parser.add_argument("--labels", default=None,
                        help="label index CSV for this model's classes (default: the "
                             "bundled 537-class map when it matches the model's output)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if bool(args.input_wav) == bool(args.raw):
        parser.error("pass wav files OR --raw (stdin PCM), not both/neither")

    label_table = load_label_map(args.labels)
    cfg, model = resolve_model(args.model, device="cpu")
    outputdim = getattr(cfg, "outputdim", len(label_table))
    if outputdim != len(label_table):
        # a custom-head checkpoint with the default 537-class table: naming
        # class i after AudioSet row i would be wrong
        labels = {i: f"class_{i}" for i in range(cfg.outputdim)}
    else:
        labels = label_table

    from ..serve import OnlineEventDetector, StreamingConfig, StreamingTagger

    # int16 ring buffers: lossless for 16-bit PCM sources and half the
    # host->device bytes a hop
    sc = StreamingConfig(hop_seconds=args.hop, threshold=args.threshold,
                         refractory_seconds=args.refractory, dtype="int16")
    tagger = StreamingTagger(cfg, model, config=sc, device=args.device)
    # models with a smaller head track all their classes; 537-way models
    # track the AudioSet range
    n_tracked = min(sc.n_audioset, outputdim)
    tracked = (sorted({int(x) for x in args.track_classes.split(",")})
               if args.track_classes else None)
    if tracked:
        # fail at startup, not mid-stream on the first scored window
        bad = [i for i in tracked if not 0 <= i < outputdim]
        if bad:
            parser.error(f"--track-classes indices {bad} out of range for this model's "
                         f"{outputdim}-way output")
        beyond_as = [i for i in tracked if i >= n_tracked]
        if beyond_as:
            print(f"# note: tracked indices {beyond_as} lie beyond the AudioSet range "
                  f"(>= {n_tracked}); keyword classes already fire through the "
                  f"--threshold trigger path, so the event detector will report them "
                  f"twice", file=sys.stderr)
    on_threshold = args.on_threshold
    if args.thresholds is not None:
        from ..evaluate.events import load_thresholds

        on_threshold = load_thresholds(args.thresholds)
    detector = (OnlineEventDetector(
        on_threshold=on_threshold, off_threshold=args.off_threshold,
        hang_seconds=args.hang, min_duration=args.min_duration,
        n_audioset=n_tracked, window_seconds=sc.window_seconds, classes=tracked)
        if args.events else None)

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def emit_sound_event(ev):
        emit({"kind": "event", "label": labels[ev.cls], "onset": round(ev.onset, 3),
              "offset": round(ev.offset, 3), "peak": round(ev.peak_prob, 4)})

    def handle(window_events):
        for ev in window_events:
            if args.windows:
                top = np.argsort(ev.probs)[::-1][: args.topk]
                emit({"kind": "window", "t": round(ev.time, 3),
                      "top": [[labels[int(i)], round(float(ev.probs[i]), 4)] for i in top]})
            for cls, prob in ev.triggers:
                emit({"kind": "trigger", "t": round(ev.time, 3), "keyword": labels[cls],
                      "prob": round(prob, 4)})
            if detector is not None:
                for sev in detector.update(ev.stream, ev.time, ev.probs):
                    emit_sound_event(sev)

    hop_samples = int(sc.hop_seconds * sc.sample_rate)
    if args.raw:
        while True:
            buf = sys.stdin.buffer.read(hop_samples * 2)
            if not buf:
                break
            # a stream cut mid-sample leaves an odd byte; drop it
            chunk = np.frombuffer(buf[: len(buf) // 2 * 2], dtype="<i2")
            if chunk.size:
                handle(tagger.feed_audio(chunk))
    else:
        from ..data import read_wav

        for wavpath in args.input_wav:
            wave, sr = read_wav(wavpath)
            if sr != sc.sample_rate:
                raise ValueError(f"{wavpath}: expected {sc.sample_rate} Hz, got {sr}")
            samples = wave[0]
            for lo in range(0, samples.shape[0], hop_samples):
                handle(tagger.feed_audio(samples[lo: lo + hop_samples]))
    if detector is not None:
        for sev in detector.flush():
            emit_sound_event(sev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
