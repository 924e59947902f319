"""Benchmark CLI: throughput + latency for any model/batch on this card.

    python -m uit_mobile_tpu_torch.cli.bench [-m uit_xs] [-b 2048] [--no-kernel]
    python -m uit_mobile_tpu_torch.cli.bench --frontend-only     # mel kernel alone
    python -m uit_mobile_tpu_torch.cli.bench --serve              # TaggingService
    python -m uit_mobile_tpu_torch.cli.bench --stream --streams 1024
    python -m uit_mobile_tpu_torch.cli.bench --train --train-layout tfb

Prints one JSON record per run. Its fields carry the names of the JAX CLI's
printed ``name=value`` fields (``batch``, ``clip``, ``device``, ``pipelined``,
``blocking_p50``; ``p50``/``p95``/``p99`` for --serve; ``batch`` and ``loss``
for --train), plus the card (``nvidia-smi --query-gpu=name,power.limit``),
its name and the counts of mel-kernel launches in the timed region. Random
weights from a seed; runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import models
from ..frontend import FrontendConfig, quantize_pcm16
from ..ops import launches, make_frontend_fn
from ..ops.pipeline import make_block_builder, make_forward_fn, make_scanned_forward
from ..utils.device import resolve_device
from ..utils.flops import device_peak_flops, uit_forward_flops


def card_line():
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it, or
    None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def _percentiles(ms) -> dict:
    ms = np.asarray(ms, dtype=np.float64)
    return {f"p{p}": float(np.percentile(ms, p)) for p in (50, 95, 99)}


def _bench_cfg(name, compute_dtype: str = "float32"):
    """Model config with the bench's UiT-oriented kwargs filtered to the
    fields the family's config declares."""
    fields = {f.name for f in dataclasses.fields(models.get_model_config(name))}
    wanted = dict(target_length=102, compute_dtype=compute_dtype)
    extra = {k: v for k, v in wanted.items() if k in fields}
    return models.get_model_config(name, outputdim=537, **extra)


def _build(cfg, dev, seed=0):
    return models.build(cfg, torch.Generator().manual_seed(seed), device=dev)


def _wav(rng, shape, dtype):
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    return quantize_pcm16(w) if dtype == "int16" else w


def _reset_launches():
    for k in launches:
        launches[k] = 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="uit-bench-torch")
    parser.add_argument("-m", "--model", default="uit_xs")
    parser.add_argument("-b", "--batch-size", type=int, default=2048)
    parser.add_argument("--seconds", type=float, default=1.0, help="clip length")
    parser.add_argument("--no-kernel", action="store_true",
                        help="the rfft reference frontend instead of the fused mel kernel")
    parser.add_argument("--exact", action="store_true",
                        help="exact DFT precision instead of the fast 3-pass-bf16 mode")
    parser.add_argument("--frontend-only", action="store_true")
    parser.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                        help="compute dtype of the benchmarked model")
    parser.add_argument("--scan", type=int, default=None, metavar="K",
                        help="run the forward (or the train step) as K batches per call")
    parser.add_argument("--train", action="store_true",
                        help="benchmark the fused PSL training step instead of inference")
    parser.add_argument("--train-layout", default="bft", choices=["bft", "tfb"],
                        help="student mel layout for --train (the PSL teacher reads "
                             "'bft' through 'tfb_to_bft')")
    parser.add_argument("--serve", action="store_true",
                        help="request latency through the TaggingService under "
                             "closed-loop load (p50/p95/p99 per request, batching included)")
    parser.add_argument("--serve-requests", type=int, default=512)
    parser.add_argument("--serve-concurrency", type=int, default=64)
    parser.add_argument("--stream", action="store_true",
                        help="always-on streaming capacity: S concurrent streams re-scored "
                             "every hop (MultiStreamTagger.feed_all) -> windows/s and the "
                             "real-time stream count this card sustains")
    parser.add_argument("--streams", type=int, default=1024,
                        help="concurrent streams for --stream")
    parser.add_argument("--hop", type=float, default=0.25,
                        help="re-score cadence in seconds for --stream")
    parser.add_argument("--dtype", default="float32", choices=["float32", "int16"],
                        help="feed raw int16 PCM (half the transfer bytes, "
                             "bitwise-identical results)")
    parser.add_argument("--profile", metavar="LOGDIR", default=None,
                        help="capture a torch.profiler trace of 3 batches")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    use_kernel = cuda and not args.no_kernel
    prec = "exact" if args.exact else "fast"
    B = args.batch_size
    T = int(16000 * args.seconds)
    record = {"model": args.model, "device": "gpu" if cuda else "cpu",
              "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "card": card_line() if cuda else None, "dtype": args.dtype,
              "kernel": use_kernel, "precision": prec, "compute_dtype": args.compute_dtype}

    def emit(rec):
        print(json.dumps({**record, **rec}), flush=True)
        return 0

    if args.serve:
        from ..serve import ServiceConfig, TaggingService

        cfg = _bench_cfg(args.model, args.compute_dtype)
        svc = TaggingService(
            cfg, _build(cfg, dev),
            ServiceConfig(batch_size=min(B, 256), max_seconds=max(2, int(np.ceil(args.seconds))),
                          use_kernel=use_kernel, dtype=args.dtype), device=dev)
        rng = np.random.default_rng(0)
        clips = [_wav(rng, T, args.dtype) for _ in range(16)]
        lat: list[float] = []
        lock = threading.Lock()
        conc = max(1, min(args.serve_concurrency, args.serve_requests))
        per_client = max(1, args.serve_requests // conc)

        def client(i):
            r = np.random.default_rng(i)
            for _ in range(per_client):
                t0 = time.perf_counter()
                svc.submit(clips[int(r.integers(len(clips)))]).result(timeout=120)
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)

        try:
            svc.submit(clips[0]).result(timeout=600)  # warm the 1 s bucket
            _reset_launches()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(conc)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        finally:
            svc.close()
        return emit({"mode": "serve", "requests": len(lat), "concurrency": conc,
                     "req_per_s": len(lat) / wall, **_percentiles(np.asarray(lat) * 1e3),
                     "wall_s": wall, "launches": dict(launches)})

    if args.stream:
        from ..serve import MultiStreamTagger, StreamingConfig

        cfg = _bench_cfg(args.model, args.compute_dtype)
        S = args.streams
        sc = StreamingConfig(hop_seconds=args.hop, use_kernel=use_kernel, dtype=args.dtype)
        tagger = MultiStreamTagger(cfg, _build(cfg, dev), n_streams=S, config=sc, device=dev)
        hop = int(sc.hop_seconds * sc.sample_rate)
        rng = np.random.default_rng(0)
        chunks = [_wav(rng, (S, hop), args.dtype) for _ in range(4)]
        # fill the 1 s ring buffers, then time steady-state hops
        for i in range(int(np.ceil(sc.window_seconds / sc.hop_seconds))):
            tagger.feed_all(chunks[i % 4])
        iters = 12 if cuda else 2
        _reset_launches()
        n_events, hop_ms = 0, []
        t0 = time.perf_counter()
        for i in range(iters):
            t1 = time.perf_counter()
            n_events += len(tagger.feed_all(chunks[i % 4]))
            hop_ms.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t0
        windows_s = n_events / wall
        # each always-on stream needs 1/hop windows per second
        return emit({"mode": "stream", "streams": S, "hop": sc.hop_seconds,
                     "hops": iters, "windows_per_s": windows_s,
                     "realtime_streams": windows_s * sc.hop_seconds,
                     "ms_per_hop": wall / iters * 1e3,
                     "feed_all_p50_ms": float(np.percentile(hop_ms, 50)),
                     "feed_all_p99_ms": float(np.percentile(hop_ms, 99)),
                     "launches": dict(launches),
                     "launches_per_hop": sum(launches.values()) / iters})

    if args.train:
        return emit(_bench_train(args, dev, use_kernel, prec))

    # two distinct buffers, alternated
    wav = torch.from_numpy(_wav(np.random.default_rng(0), (B, T), args.dtype)).to(dev)
    wav2 = torch.from_numpy(_wav(np.random.default_rng(1), (B, T), args.dtype)).to(dev)
    bufs = [wav, wav2]
    flops_per_clip = None
    if args.frontend_only:
        fwd = torch.inference_mode()(make_frontend_fn(FrontendConfig(), use_kernel=use_kernel,
                                                      precision=prec))
        label = f"frontend({'kernel' if use_kernel else 'rfft'})"
    else:
        cfg = _bench_cfg(args.model, args.compute_dtype)
        # the serving policy (tfb for UiT, tfb_to_bft mel for MobileNetV2)
        fwd = make_forward_fn(cfg, _build(cfg, dev), use_kernel=use_kernel, precision=prec)
        label = f"{args.model}({'kernel' if use_kernel else 'rfft'} frontend)"
        if isinstance(cfg, models.UITConfig):
            flops_per_clip = uit_forward_flops(cfg, T)
    clips_per_call = B
    if args.scan:
        K = args.scan
        fwd = make_scanned_forward(fwd)
        mkblock = make_block_builder(K)
        bufs = [mkblock(wav, wav2, j * K) for j in range(2)]
        clips_per_call = K * B
        label += f" scan K={K}"
    calls = [0]

    def run():
        calls[0] += 1
        return fwd(bufs[calls[0] % 2])

    run()
    sync()
    rounds, depth = (4, 8) if cuda else (2, 2)
    if args.scan:
        depth = max(2, depth // 4)
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for _ in range(depth):
            run()
        sync()
    thr = rounds * depth * clips_per_call / (time.perf_counter() - t0)
    timed_launches = dict(launches)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        run()
        sync()
        times.append(time.perf_counter() - t0)
    graphs = getattr(fwd, "graphs", None)

    def eager():
        with torch.inference_mode():
            return graphs.fn(bufs[0])

    rec = {"mode": "frontend" if args.frontend_only else "forward", "label": label,
           "batch": B, "clip": args.seconds, "scan": args.scan, "pipelined": thr,
           **_eager_vs_replay(run, eager if graphs is not None else None, sync),
           "blocking_p50": float(np.percentile(times, 50)) * 1e3,
           "blocking_p50_unit": f"ms/call({args.scan} batches)" if args.scan else "ms/batch",
           "launches": timed_launches,
           "model_flops_per_clip": flops_per_clip,
           "mfu": (thr * flops_per_clip / device_peak_flops(dev)
                   if cuda and flops_per_clip and device_peak_flops(dev) else None)}
    if args.profile:
        from ..utils.profiling import device_dispatch_ms, device_memory_stats, trace

        with trace(args.profile):
            for _ in range(3):
                run()
                sync()
        rec.update({"trace": args.profile,
                    "device_dispatch_ms": device_dispatch_ms(args.profile),
                    "memory": device_memory_stats()})
    return emit(rec)


def _bench_train(args, dev, use_kernel, prec) -> dict:
    """The fused PSL train step (AdamW, mixup 0.3, clip 1.0) on flat
    [audioset | kws] batches, with the untrained MobileNetV2 teacher."""
    from ..train import build_optimizer, make_multi_step, make_train_step

    B = args.batch_size
    T = int(16000 * args.seconds)
    cfg = _bench_cfg(args.model, args.compute_dtype)
    psl_cfg = models.get_model_config("MobileNetV2", outputdim=527)
    if args.train_layout != "bft":
        if not isinstance(cfg, models.UITConfig):
            raise SystemExit(f"--train-layout {args.train_layout} needs a UiT model")
        cfg = dataclasses.replace(cfg, mel_layout=args.train_layout)
    model, teacher = _build(cfg, dev), _build(psl_cfg, dev, seed=1).eval()
    optimizer = build_optimizer("AdamW", 1e-3, weight_decay=5e-8).init(model)
    step = make_train_step(
        cfg, model, optimizer, mixup_alpha=0.3, max_grad_norm=1.0, psl_cfg=psl_cfg,
        psl_model=teacher, psl_split=B // 2,
        frontend_fn=make_frontend_fn(cfg.frontend, use_kernel=use_kernel, precision=prec,
                                     layout=args.train_layout),
        psl_frontend_fn=make_frontend_fn(psl_cfg.frontend, use_kernel=use_kernel,
                                         precision=prec, layout="tfb_to_bft"))
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def mk(lead=()):
        return {"wav": torch.from_numpy(_wav(rng, (*lead, B, T), args.dtype)).to(dev),
                "target": torch.from_numpy(
                    (rng.random((*lead, B, 537)) < 0.02).astype(np.float32)).to(dev)}

    K = args.scan or 1
    if args.scan:
        step = make_multi_step(step)
    batches = [mk((K,) if args.scan else ()), mk((K,) if args.scan else ())]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    m = step(batches[0], gen)
    sync()
    iters = (10 if dev.type == "cuda" else 3) if not args.scan else max(2, 10 // K * 2)
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(iters):
        m = step(batches[i % 2], gen)
    sync()
    dt = (time.perf_counter() - t0) / (iters * K)
    loss = m["total_loss"].reshape(-1)[-1]
    launched = dict(launches)
    graphs = step.graphs

    def eager():  # the same K steps through the body the graph holds
        kinds = optimizer.plan(K)
        return graphs.fn(batches[0], gen, kinds if args.scan else kinds[0])

    return {"mode": "train", "layout": args.train_layout, "batch": B, "scan": args.scan,
            "ms_per_step": dt * 1e3, "clips_per_s": B / dt, "loss": float(loss),
            "launches": launched,
            **_eager_vs_replay(lambda: step(batches[0], gen),
                               eager if graphs is not None else None, sync)}


def _eager_vs_replay(call, eager, sync, n: int = 5) -> dict:
    """Blocking ms of one call (median of n), as a CUDA-graph replay and
    through the eager body it holds, side by side; where nothing is graphed
    (the CPU) the call is the eager body and ``replay_ms`` is None."""
    def p50(fn):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.percentile(times, 50))

    if eager is None:
        return {"eager_ms": p50(call), "replay_ms": None}
    return {"eager_ms": p50(eager), "replay_ms": p50(call)}


if __name__ == "__main__":
    sys.exit(main())
