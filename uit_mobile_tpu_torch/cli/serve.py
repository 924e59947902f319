"""Serving CLI: a stdin/stdout (or HTTP) tagging service on the card.

    python -m uit_mobile_tpu_torch.cli.serve -m ckpt.npz [-k 5] [--batch-size 256]
    python -m uit_mobile_tpu_torch.cli.serve -m ckpt.npz --http 8000
    python -m uit_mobile_tpu_torch.cli.serve -m ckpt.npz --device cpu < paths.txt
    python -m uit_mobile_tpu_torch.cli.serve --artifact model.uitx [--dtype float32]

Reads wav paths (one per line) on stdin, emits one JSON line per clip:
    {"path": ..., "top": [[label, prob], ...]}
Requests are batched across stdin lines by the TaggingService. With
``--http PORT`` it serves POST /tag, /events, /stream/*, /reload and GET
/healthz, /metrics, /labels instead (serve/http.py).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque

import numpy as np

from ..data import read_wav
from .common import load_label_map, resolve_model


def main(argv=None):
    parser = argparse.ArgumentParser(prog="uit-serve-torch")
    parser.add_argument("-m", "--model", default="uit_xs")
    parser.add_argument("--artifact", default=None, metavar="MODEL.uitx",
                        help="serve an exported artifact (cli.export --artifact, "
                             "batch-polymorphic) instead of -m: no model code runs; "
                             "/events, /stream/* and /reload are unavailable")
    parser.add_argument("-k", "--topk", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--max-seconds", type=int, default=10)
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard each bucket batch over all visible cards (not yet "
                             "ported, ROADMAP §A17)")
    parser.add_argument("--top-db-mode", default="per_sample",
                        choices=["per_sample", "torch"],
                        help="dB-clamp reference: per_sample isolates co-batched requests "
                             "(default); torch = offline-eval parity")
    parser.add_argument("--dtype", default="int16", choices=["int16", "float32"],
                        help="transfer dtype: int16 keeps PCM 2-byte across the "
                             "host->device copy (bitwise-identical output)")
    parser.add_argument("--low-latency", action="store_true",
                        help="ServiceConfig.low_latency() preset: small bucket, zero "
                             "batching window, scan folding off; explicit "
                             "--batch-size/--dtype still override")
    parser.add_argument("--scan-batches", type=int, default=1, metavar="K",
                        help="enqueue K pending full batches of a bucket together under "
                             "sustained load (results match the per-batch path)")
    parser.add_argument("--http", type=int, default=None, metavar="PORT",
                        help="serve over HTTP on PORT instead of stdin/stdout")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address for --http (default loopback)")
    parser.add_argument("--stream-sessions", type=int, default=32,
                        help="slot count for the --http /stream session API")
    parser.add_argument("--calibration", default=None, metavar="JSON",
                        help="temperature-scaling file from `cli.evaluate calibrate -o`: "
                             "probabilities on every surface (/tag, /events, /stream/*) "
                             "are calibrated on the host before thresholds apply")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..serve import ServiceConfig, TaggingService

    labels = load_label_map()
    cfg = model = None
    if args.artifact is not None:
        service = TaggingService.from_artifact(
            args.artifact, ServiceConfig(batch_size=args.batch_size, warmup=not args.no_warmup,
                                         dtype=args.dtype),
            device=args.device, calibration=args.calibration)
        # prefer the label map sealed into the artifact at export time
        if service.artifact_meta.get("labels"):
            labels = {int(k): v for k, v in service.artifact_meta["labels"].items()}
        model_name = args.artifact
    else:
        # the model is read onto the CPU; every serving surface copies it to --device
        cfg, model = resolve_model(args.model, device="cpu")
        if args.low_latency:
            # preset fields win; non-default CLI values still override
            overrides = dict(max_seconds=args.max_seconds, warmup=not args.no_warmup,
                             data_parallel=args.data_parallel, top_db_mode=args.top_db_mode)
            if args.batch_size != parser.get_default("batch_size"):
                overrides["batch_size"] = args.batch_size
            if args.dtype != parser.get_default("dtype"):
                overrides["dtype"] = args.dtype
            svc_cfg = ServiceConfig.low_latency(**overrides)
        else:
            svc_cfg = ServiceConfig(batch_size=args.batch_size, max_seconds=args.max_seconds,
                                    warmup=not args.no_warmup,
                                    data_parallel=args.data_parallel,
                                    top_db_mode=args.top_db_mode, dtype=args.dtype,
                                    scan_batches=args.scan_batches)
        service = TaggingService(cfg, model, svc_cfg, device=args.device,
                                 calibration=args.calibration)
        model_name = args.model
    print("ready", file=sys.stderr, flush=True)

    if cfg is not None and getattr(cfg, "outputdim", len(labels)) != len(labels):
        # custom-head checkpoint: index names instead of the AudioSet table
        labels = {i: f"class_{i}" for i in range(cfg.outputdim)}

    if args.http is not None:
        return _serve_http(args, cfg, model, service, labels, model_name)

    pending: deque = deque()

    def emit(path, probs):
        top = np.argsort(probs)[::-1][: args.topk]
        out = {"path": path,
               "top": [[(f"Keyword: {name}" if i > 526 else name), round(float(probs[i]), 4)]
                       for i in top for name in [labels.get(int(i), f"class_{int(i)}")]]}
        print(json.dumps(out), flush=True)

    with service:
        for line in sys.stdin:
            path = line.strip()
            if not path:
                continue
            wav, sr = read_wav(path)
            if sr != service.cfg.sample_rate:
                raise ValueError(f"{path}: expected {service.cfg.sample_rate} Hz, got {sr}")
            pending.append((path, service.submit(wav[0])))
            # drain completed results incrementally, in submit order: a
            # long-running producer sees output before stdin closes
            while pending and pending[0][1].done():
                p, fut = pending.popleft()
                emit(p, fut.result())
        for path, fut in pending:
            emit(path, fut.result())
    return 0


def _serve_http(args, cfg, model, service, labels, model_name) -> int:
    from ..serve import StreamSessions, make_framewise_fn, serve_http

    if cfg is None:  # an artifact: the exported program is all there is
        with service:
            print(f"http://{args.host}:{args.http}", file=sys.stderr, flush=True)
            serve_http(service, labels=labels, host=args.host, port=args.http,
                       topk=args.topk, model_name=model_name, quiet=False)
        return 0
    try:  # temporal tagging (/events) for the families that support it
        framewise_fn = make_framewise_fn(cfg, model, max_seconds=args.max_seconds,
                                         device=args.device)
    except TypeError:  # e.g. the MoE: no framewise forward
        framewise_fn = None
    stream_sessions = StreamSessions(cfg, model, max_sessions=args.stream_sessions,
                                     calibration=args.calibration, device=args.device)

    def reload_fn(has_events=framewise_fn is not None):
        """POST /reload: re-read the checkpoint this server was started from
        and swap every surface that can."""
        cfg2, model2 = resolve_model(args.model, device="cpu")
        info = {"weights_version": service.reload(model2, model_cfg=cfg2),
                "source": args.model}
        if has_events:
            info["_framewise_fn"] = make_framewise_fn(cfg2, model2, max_seconds=args.max_seconds,
                                                      device=args.device)
        ok = stream_sessions.reload(cfg2, model2)
        info["stream_sessions"] = (
            "reloaded" if ok else
            "deferred: active sessions keep the previous weights; POST /reload again "
            "once they close or expire")
        return info

    with service:
        print(f"http://{args.host}:{args.http}", file=sys.stderr, flush=True)
        serve_http(service, labels=labels, host=args.host, port=args.http, topk=args.topk,
                   model_name=model_name, quiet=False, framewise_fn=framewise_fn,
                   stream_sessions=stream_sessions, reload_fn=reload_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
