#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uit_mobile_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mp-cards 4   # the model-parallel routes on four cards

Phases, each printing one JSON line:
  1. device  - the card (nvidia-smi name and power limit), torch/CUDA versions,
               TF32 flags (off);
  2. build   - nvcc builds every kernel source in uit_mobile_tpu_torch/csrc;
  3. kernel checks - each variant of the fused mel kernel at the shapes the
               serving and exact paths give it, against its plain PyTorch
               version, the rfft reference, the fast/exact gates, int16 ==
               f32/32768 and transposed == row (bitwise), and against a
               float64 sum of the same products; ragged shapes and noise
               where a DFT sum cancels; timed beside its plain version and
               a torch.stft composite; the exact kernel on the committed
               torch.stft golden (3e-2 dB) and the fast kernel's B=1 output
               bitwise row 0 of a B=2 call (tools/verify_tpu_numerics.py's
               checks);
  4. serve   - the main path: uit_xs (random weights from a seed) behind
               TaggingService(ServiceConfig(dtype="int16")) on the card,
               ~300 one-second and 20 three-second clips, each result held
               within 1e-3 of the plain path on the CPU;
  5. exact   - make_forward_fn(precision="exact") at B=4 and B=256 against the
               CPU plain path, and the inference CLI with --kernel on the card
               against the CPU run;
  6. forward - device and host-enqueue time of one serving forward at each
               serving shape, beside the mel kernel's share of it;
  7. train   - the training path: the port's Trainer at full uit_xs width
               and depth with the untrained MobileNetV2 PSL teacher, on
               in-memory clips of data/synthworld.py, at the recipe of
               configs/train_uit_xs.yaml (B=32, bft, exact: row_exact in
               student and teacher) and at its throughput frontier (B=1024,
               tfb, fast, int16: tfb_fast in both); the recipe's averaged.npz
               served; each configuration's step timed (step ms, host
               enqueue ms, mel and teacher shares, clips/s) and the
               trainer's two frontends on that batch held against their
               plain versions; one step of each configuration on the card
               held against the CPU plain path (train_parity);
  8. eval    - the evaluation path: the Evaluator on the recipe's averaged.npz
               (`cli.train run`'s GSC + AudioSet evaluation, then calibrate,
               strong with a sweep and PSDS, fast, int16 and a two-member
               ensemble) on in-memory clips of data/synthworld.py (64 one-second
               GSC clips, 64 ten-second AudioSet clips, 16 ten-second strong
               clips), each mode held against the same Evaluator on the CPU plain
               path; the mel frontend at the eval shapes against its plain
               version; cli.evaluate test_sample and cli.infer --timestamps/
               --events on the card against the CPU; per batch forward ms vs
               enqueue ms, mel share, launches, device idle share; clips/s of a
               warm AudioSet and GSC epoch;
  9. stream  - MultiStreamTagger (uit_xs) on the card: S=1024 streams, int16
               ring (tfb_fast) and S=16, float32 ring (row_fast), 12 feed_all
               hops each after feed() seeds the rings; windows/s, real-time
               streams sustained, feed_all p50/p99, launches a hop, the card's
               idle share over 5 hops (utils/profiling.py); held against the
               CPU plain path (1e-3), the host path (bitwise) and the other
               ring dtype (bitwise);
 10. http    - make_http_server on 127.0.0.1:0 over a card TaggingService,
               StreamSessions (8 slots) and the /events scorer: 64 concurrent
               POST /tag (WAV, pcm16, f32; 1 s and 3 s), /events on a 10 s clip,
               one /stream session, /healthz, /metrics, /reload, a calibrated
               service; held against the CPU plain path (1e-3, top-k up to
               ties, events on the classes clear of the threshold);
 11. bench   - cli.bench.main in this process: --serve, --stream, --frontend-only
               at small counts, each record checked for the JAX CLI's fields.
The rest of training runs after the train phase:
  bf16      - the frontier with compute_dtype bfloat16 in encoder and teacher
              through the Trainer; its step and the float32 step from the same
              weights timed in turns and profiled; drift of a step's loss and
              of the serving forward against float32 (<= 5e-3, > 0);
  psl_cache - cli.psl_cache's scoring (MobileNetV2 teacher, B=256, row_exact)
              of every grid crop of 64 one- and ten-second eventful clips, 8 of
              them held against the CPU teacher; 3 recipe steps with psl:
              {mode: offline} on that in-memory cache; one offline step
              against the online-PSL step (1e-3);
  sed       - configs/train_sed.yaml's recipe (B=64, exact, row_exact) for 2
              epochs of 5 steps on in-memory eventful clips with their events,
              segment-F1 validation, best_sed.npz served framewise; one step
              against the CPU plain path (1e-4);
  pretrain  - configs/pretrain_mae.yaml's recipe (target_length 1012, B=64) for
              5 steps; one MAE forward against the CPU with the same noise
              (1e-4); the snapshot into a 102-frame Trainer, card == CPU.
  export    - uit_xs exported with the kernel (ckpt/artifact.py) at the serving
              shape (B=256 x 1 s int16 fast: tfb_fast) and at B=4 float32 exact
              (row_exact), each reloaded from its file and held bitwise or
              within 1e-6 of make_forward_fn on the card and within 1e-3 of the
              CPU plain path; batch-polymorphic plain artifacts of 1 s and 3 s
              clips served through TaggingService.from_artifact (1e-3 of the
              CPU); cli.export --artifact --kernel --verify, cli.export -o .pt
              and cli.average; export and load seconds, file sizes, call ms
              against make_forward_fn's;
  moe       - uit_xs_moe at full width (8 experts, top-2, target_length 1012)
              served at B=32 x 10 s int16 exact (row_exact, 1e-3 of the CPU),
              5 make_moe_train_step steps (AdamW) with step ms, kernels a
              step, idle share, peak memory and the routed MLP's share; one
              step against the CPU (frontend and the step after it gated
              apart, tokens routed differently counted); 3 recipe steps with
              optimizer Adafactor through the Trainer, one step against the
              CPU.
After bench:
  parallel  - data parallelism on the one card (phase_parallel): the recipe
              on a synthetic world of files through `cli.launch 1` (the
              training CLI as one NCCL rank) against `cli.train` in one
              process (last.npz bitwise, or the largest gap; launches and
              epoch step times from the Trainer's log); two ranks sharing the card over
              gloo (recipe B=32 and frontier B=1024 steps against the
              single-process global step, given the ranks' ReLU signs and
              without; mel launches by rank); the FSDP step (two gloo ranks
              when gloo carries FSDP2's collectives for CUDA tensors, else
              one NCCL rank); the Evaluator and TaggingService over two
              replicas of the card, the kernel on every shard; the one-rank
              step's cost beside the single-process step's. Not a scaling
              measurement.
  model_parallel - model parallelism on the one card (phase_model_parallel):
              every route as one NCCL rank (meshes of ones) and as four
              gloo ranks sharing the card: TP 2x2 with and without sharded
              attention, a hybrid FSDP x TP 2x2 weak step, SP seq=4 (float32
              exact, bfloat16, int16 fast) and data 2 x seq 2, PP pipe=4 at
              M=4 and M=8 (and int16 fast), EP data 2 x expert 2 on
              uit_xs_moe (B=32 x 10 s forward and one AdamW step); the mel
              kernel on every rank's rows; forwards within 2e-5 (bfloat16
              5e-3) of the single-process card forward, steps as the
              parallel phase's; launches, forward ms and weight bytes by
              rank. Not a scaling measurement.
  gate      - the synthetic accuracy gate at full size on the card
              (uit_mobile_tpu_torch/tools/gate_synthetic.py in its own
              process): uit_xxxs trained through cli.train on the synthetic
              keyword world (.npz store), scored through cli.evaluate
              audioset and gsc: mAPKWS and GSC Accuracy@0.2 >= 0.80, the
              mel kernel launched in training and in each evaluation; then
              cli.prep gsc on a GSC-shaped wav tree to an .npz store, its
              test split scored on the card by the gate's model.
Then the `kernels` line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Launch counters are set to 0 just before the serve, exact, train, bf16,
psl_cache scoring, offline, sed, pretrain, each artifact call, each moe path,
each eval, each stream, the http path, each parallel and
model-parallel path (in each rank's own process, or from the start of a
training CLI's process, which logs its count at its end) and each of the
gate's train and evaluate calls and its prep scoring, and read just after;
comparison launches do not count.
Any failure exits non-zero without that last line, as does a machine
with no CUDA GPU.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "uit_mobile_tpu_torch" / "_build" / "chip_smoke"  # gitignored

# H100 SXM data-sheet peaks (dense): HBM bytes/s, FP32 non-tensor, bf16 tensor
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
KERNEL_SOURCE = "uit_mobile_tpu_torch/csrc/mel.cu"
REPLACES = {
    "row_exact": "uit_mobile_tpu/ops/pallas_mel.py:101",
    "row_fast": "uit_mobile_tpu/ops/pallas_mel.py:142",
    "tfb_exact": "uit_mobile_tpu/ops/pallas_mel.py:180",
    "tfb_fast": "uit_mobile_tpu/ops/pallas_mel.py:192",
}
# each variant's gate against its plain version (phase_kernels)
TOLERANCE = {
    "exact": "1e-3 dB at the timed shapes; elsewhere 1e-3 dB + {} float32 roundings of each "
             "DFT sum (ops/mel.py:tolerance_db)",
    "fast": "1e-3 dB + {} float32 roundings of each DFT sum (ops/mel.py:tolerance_db)",
}
SR = 16000
# a kernel instance's mangled name in ptxas's log: input type, transposed, DFT passes
KERNEL_RE = re.compile(r"mel_kernelI([sf])Lb([01])ELi([36])E")
PRECISION_OF_PASSES = {"3": "fast", "6": "exact"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke gate failed: {msg}")


def time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one fn() in ms when `calls` calls are issued back to
    back between two CUDA events (median of `reps` runs): without the host's
    launch gap that time_ms counts, which is comparable to a 0.1 ms kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def real_clip(n: int) -> np.ndarray:
    """The GSC keyword sample, tiled to n samples (float32 from int16 PCM)."""
    from uit_mobile_tpu_torch.data import read_wav

    wav, _ = read_wav(REPO / "samples" / "85b877b5_nohash_0.wav")
    return np.resize(wav[0], n)


def pcm_batch(rng, B: int, n: int) -> np.ndarray:
    """(B, n) int16: seeded noise at 0.1 amplitude, row 0 the real sample."""
    from uit_mobile_tpu_torch.frontend import quantize_pcm16

    wav = rng.standard_normal((B, n)).astype(np.float32) * 0.1
    wav[0] = real_clip(n)
    return quantize_pcm16(wav)


def noise_by_shape(B: int, n: int) -> np.ndarray:
    """(B, n) int16 noise seeded by the shape, as tests/test_torch_mel_gpu.py
    makes it, row 0 the real sample."""
    from uit_mobile_tpu_torch.frontend import quantize_pcm16

    wav = np.random.default_rng(B + n).standard_normal((B, n)) * 0.1
    pcm = np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)
    pcm[0] = quantize_pcm16(real_clip(n))
    return pcm


def bound(B: int, n_samples: int, precision: str, int16: bool):
    """(bound_ms, bound_by, fp32_fma_bound_ms) for one call at this shape:
    the larger of bytes / HBM rate and operations / peak rate for the work
    the kernel does on the tensor cores (DFT in 3 bf16 passes fast, 6 exact;
    filterbank in 3), and the same function's operations at the FP32
    (non-tensor) rate, the ceiling of a DFT in FP32 FMA."""
    from uit_mobile_tpu_torch.frontend import FrontendConfig

    fe = FrontendConfig()
    n_frames = fe.num_frames(n_samples)
    rows = B * n_frames
    dft, fbank = rows * 2 * 512 * 512, rows * 2 * 512 * 64
    g_pieces = 2 if precision == "fast" else 3  # bf16 pieces of each DFT operand
    dft_passes = 3 if precision == "fast" else 6
    op_s = (dft_passes * dft + 3 * fbank) / PEAK_BF16_FLOP_S
    mat_bytes = 2 * g_pieces * 512 * 512 + 2 * 2 * 512 * 64  # the packed operands
    nbytes = B * (n_samples + 512) * (2 if int16 else 4) + mat_bytes + rows * 64 * 4
    byte_s = nbytes / PEAK_BYTES_S
    return (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes",
            (dft + fbank) / PEAK_FP32_FLOP_S * 1e3)


def library_composite(wav_f: torch.Tensor, fb: torch.Tensor, window: torch.Tensor):
    """Nearest PyTorch yardstick (a composite, no single call computes the
    fused function): torch.stft -> power -> @ fb -> 10*log10."""
    spec = torch.stft(wav_f, n_fft=512, hop_length=160, win_length=512, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                 # (B, 257, T)
    mel = power.transpose(-1, -2) @ fb                      # (B, T, 64)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}
    check(not any(info["tf32"].values()), "TF32 must be off")
    emit(info)
    return info


def phase_build() -> None:
    from uit_mobile_tpu_torch.ops import build
    from uit_mobile_tpu_torch.ops.build import load_library

    t0 = time.perf_counter()
    paths = build.build_all()
    seconds = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for stem, log in build.build_logs.items():
        (OUT_DIR / f"nvcc_{stem}.log").write_text(log)
    lib = load_library("mel")
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libraries": {k: str(v.relative_to(REPO)) for k, v in paths.items()},
          "ptxas": ptxas_summary(build.build_logs.get("mel", "")),
          "dynamic_smem_bytes": {"fast": lib.uit_mel_smem_bytes(1),
                                 "exact": lib.uit_mel_smem_bytes(0)}})


def ptxas_summary(log: str) -> dict:
    """Per kernel instance of csrc/mel.cu: registers, static shared memory,
    spill bytes and, where ptxas serialized its wgmmas, the reason it gave,
    from `-Xptxas -v`."""
    out, cur = {}, None
    for ln in log.splitlines():
        if (m := KERNEL_RE.search(ln)):
            key = f"mel_kernel<{'int16' if m.group(1) == 's' else 'f32'}," \
                  f"{'tfb' if m.group(2) == '1' else 'row'},{m.group(3)}> " \
                  f"({PRECISION_OF_PASSES[m.group(3)]})"
            cur = out.setdefault(key, {})
            if (why := re.search(r"serialized due to (.*?) (?:for|in) the function", ln)):
                cur["wgmma_serialized"] = why.group(1)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            cur["spill_store_bytes"], cur["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def phase_kernels(dev) -> dict:
    """Every variant vs its plain version and the gates; -> {variant: its
    timed records, the kernels line's shape first}."""
    from uit_mobile_tpu_torch.frontend import FrontendConfig, log_mel_spectrogram, reflect_pad
    from uit_mobile_tpu_torch.frontend.mel import mel_filterbank, padded_window
    from uit_mobile_tpu_torch.ops import mel as mel_ops

    fe = FrontendConfig()
    rng = np.random.default_rng(0)
    # (variant, B, samples, role): the shapes the serve and exact paths use,
    # timed (row_exact at the kernel phase's B=8 and the CLI's B=4); then
    # ragged ones for the kernel's 128-row tiles (T=16001: padded rows not a
    # multiple of 16 bytes), gates only; last, gates on the noise where a DFT
    # sum cancels (the fast kernel 7e-3 dB from plain at mel 0, frame 0)
    variants = ("row_fast", "tfb_fast", "row_exact", "tfb_exact")
    cases = [("row_fast", 8, 3 * SR, "gate"), ("row_fast", 85, 3 * SR, "timed"),
             ("tfb_fast", 256, SR, "timed"), ("row_exact", 8, SR, "timed"),
             ("row_exact", 4, SR, "timed"), ("tfb_exact", 256, SR, "timed")]
    cases += [(v, B, SR + 1, "gate") for v in variants for B in (1, 129, 257)]
    cases += [(v, 257, 3 * SR, "noise_by_shape") for v in ("row_fast", "row_exact")]
    # the Evaluator's shapes (float32 in, B=32): AudioSet 10 s and GSC 1 s
    # exact, GSC fast; timed, gated by tolerance_db
    cases += [("row_exact", 32, 10 * SR, "eval"), ("row_exact", 32, SR, "eval"),
              ("row_fast", 32, SR, "eval")]
    records, worst = {}, {}
    fb257 = torch.from_numpy(mel_filterbank(fe)).to(dev)
    window = torch.from_numpy(padded_window(512, 512)).to(dev)
    for variant, B, n_samples, role in cases:
        layout, precision = variant.split("_")
        transposed = layout == "tfb"
        secs = n_samples // SR
        pcm = (noise_by_shape(B, n_samples) if role == "noise_by_shape"
               else pcm_batch(rng, B, n_samples))
        wav_i = torch.from_numpy(pcm).to(dev)
        wav_f = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(dev)
        wp_i = reflect_pad(wav_i, 256).contiguous()
        wp_f = reflect_pad(wav_f, 256).contiguous()
        mats_i = mel_ops._matrices(fe, True, precision, dev)
        mats_f = mel_ops._matrices(fe, False, precision, dev)

        def run(wp, mats, t=transposed):
            return mel_ops.cuda_log_mel_rows(wp, mats, precision, fe.hop_length, t)

        out_f, out_i = run(wp_f, mats_f), run(wp_i, mats_i)
        plain = mel_ops.plain_log_mel_rows(wp_f, mats_f, precision, fe.hop_length)
        if transposed:
            plain = plain.permute(1, 2, 0)
        torch.cuda.synchronize()
        err = (out_f - plain).abs()
        # row 0 is the real sample, rows 1.. the noise (batch is the last
        # dim of the transposed layout)
        err_real, err_noise = (err[..., 0], err[..., 1:]) if transposed else (err[0], err[1:])
        rec = {"phase": "kernel", "variant": variant, "B": B, "samples": n_samples,
               "seconds": secs,
               "max_abs_err_db": err.max().item(), "mean_abs_err_db": err.mean().item(),
               "max_abs_err_noise_db": err_noise.max().item() if err_noise.numel() else None,
               "max_abs_err_real_db": err_real.max().item(),
               "n_over_1e-3_db": int((err > 1e-3).sum())}
        check(torch.isfinite(out_f).all().item(), f"{variant}: non-finite output")
        # kernel vs its plain version: the same products in another
        # summation order, 1e-3 dB plus a few float32 roundings of each DFT
        # sum, which is what two summation orders can differ by where a DFT
        # value cancels (mel_ops.tolerance_db; PERF.md, Findings:
        # accuracy); the exact kernel also 1e-3 dB flat at the timed shapes
        tol = mel_ops.tolerance_db(wp_f, mats_f, fe.hop_length, precision)
        if transposed:
            tol = tol.permute(1, 2, 0)
        rec["min_gate_margin_db"] = (tol - err).min().item()
        ok = rec["min_gate_margin_db"] >= 0
        if precision == "exact" and role == "timed":
            ok = ok and rec["max_abs_err_db"] <= 1e-3
        rec.update(float64_readings(mel_ops, wp_f, mats_f, fe.hop_length, precision, {
            "kernel": out_f.permute(2, 0, 1) if transposed else out_f,
            "plain": plain.permute(2, 0, 1) if transposed else plain}))
        check(ok, f"{variant} B={B}: kernel vs plain {rec['max_abs_err_noise_db']} dB (noise), "
                  f"{rec['max_abs_err_real_db']} dB (real sample)")
        rec["int16_bitwise"] = torch.equal(out_f, out_i)
        check(rec["int16_bitwise"], f"{variant} B={B}: int16 != f32/32768")
        if transposed:
            rec["transposed_bitwise"] = torch.equal(out_f, run(wp_f, mats_f, False).permute(1, 2, 0))
            check(rec["transposed_bitwise"], f"{variant} B={B}: tfb != row transposed")
        # gates through the wrapper (top_db clamp included)
        exact = mel_ops.log_mel(wav_f, fe, precision="exact", layout="btf")
        if precision == "exact":
            ref = log_mel_spectrogram(wav_f, fe).transpose(-1, -2)
            truth = log_mel_spectrogram(wav_f.double(), fe).transpose(-1, -2)
            d = (exact - ref).abs()
            rec["vs_rfft_max_db_noise"] = d[1:].max().item() if B > 1 else 0.0
            rec["vs_rfft_max_db_real"] = d[0].max().item()
            rec["vs_f64_max_db_real"] = (exact[0] - truth[0]).abs().max().item()
            rec["rfft_vs_f64_max_db_real"] = (ref[0] - truth[0]).abs().max().item()
            # the JAX gate (tests/test_pallas_mel.py:23) on its own kind of
            # input, noise at 0.1 amplitude, at the timed shapes (the ragged
            # and shape-seeded cases hold frames where the DFT cancels, and
            # there two float32 evaluations differ by more: the plain
            # version is 1.7e-3 dB from rfft at B=129 x 16001 samples). On
            # the real sample's deep valleys two float32 evaluations differ
            # by ~1e-3 dB, so there the kernel is held to a float64
            # evaluation of the frontend.
            check((role != "timed" or rec["vs_rfft_max_db_noise"] <= 5e-4)
                  and rec["vs_f64_max_db_real"] <= 2e-3,
                  f"{variant}: exact kernel vs rfft {rec['vs_rfft_max_db_noise']} dB "
                  f"(noise), vs float64 {rec['vs_f64_max_db_real']} dB (real sample)")
        else:
            d = (mel_ops.log_mel(wav_f, fe, precision="fast", layout="btf") - exact).abs()
            rec["fast_vs_exact_max_db"] = d.max().item()
            rec["fast_vs_exact_mean_db"] = d.mean().item()
            check(rec["fast_vs_exact_max_db"] < 1.0 and rec["fast_vs_exact_mean_db"] < 0.02,
                  f"{variant}: fast vs exact {d.max().item()} / {d.mean().item()} dB")
        if role in ("timed", "eval"):
            # the serve path feeds int16 (fast), the exact path and the
            # Evaluator float32
            int16_in = precision == "fast" and role == "timed"
            wp, mats = (wp_i, mats_i) if int16_in else (wp_f, mats_f)
            rec["input"] = "int16" if int16_in else "float32"
            rec["role"] = role
            rec["kernel_ms"] = time_ms(lambda: run(wp, mats))
            rec["kernel_back_to_back_ms"] = back_to_back_ms(lambda: run(wp, mats))
            rec["plain_ms"] = time_ms(
                lambda: mel_ops.plain_log_mel_rows(wp, mats, precision, fe.hop_length))
            rec["library_ms"] = time_ms(lambda: library_composite(wav_f, fb257, window))
            rec["bound_ms"], rec["bound_by"], rec["fp32_fma_bound_ms"] = bound(
                B, secs * SR, precision, rec["input"] == "int16")
            records.setdefault(variant, []).append(rec)
        worst[variant] = max(worst.get(variant, 0.0), rec["max_abs_err_db"])
        emit(rec)
    for variant, recs in records.items():
        recs[0]["max_abs_err_all_shapes_db"] = worst[variant]
    # tools/verify_tpu_numerics.py's two checks no other gate makes: the
    # exact kernel (row_exact, B=3) on the committed torch.stft golden within
    # that tool's 3e-2 dB, and the fast kernel's B=1 output bitwise row 0 of
    # a B=2 call (rows are frame-independent)
    golden = np.load(REPO / "tests" / "goldens" / "frontend_golden.npz")
    gwav = torch.from_numpy(golden["rand_batch_wav"]).to(dev)
    reset_launches()
    mel = mel_ops.log_mel(gwav, fe, precision="exact")
    m1, m2 = (mel_ops.log_mel(gwav[:b], fe, precision="fast") for b in (1, 2))
    torch.cuda.synchronize()
    rec = {"phase": "kernel", "check": "numerics", "launches": dict(mel_ops.launches),
           "golden_shape": list(mel.shape),
           "golden_max_abs_err_db": float(np.abs(mel.cpu().numpy()
                                                 - golden["rand_batch_logmel"]).max()),
           "golden_tolerance_db": 3e-2, "fast_b1_vs_b2_row0_bitwise": torch.equal(m1, m2[:1])}
    emit(rec)
    check(rec["golden_max_abs_err_db"] <= 3e-2 and rec["fast_b1_vs_b2_row0_bitwise"]
          and rec["launches"]["row_exact"] == 1 and rec["launches"]["row_fast"] == 2,
          f"kernels against the frontend golden and B=1 vs B=2: {rec}")
    return records


def float64_readings(mel_ops, wp, mats, hop: int, precision: str, outs: dict) -> dict:
    """Each output's distance from the float64 sum of the same products
    (mel_ops.log_mel_rows_float64): its largest, in dB, and in float32
    roundings of each DFT sum (mel_ops.dft_rounding_db) over the values
    where one rounding moves the output by more than 1e-4 dB, i.e. where a
    DFT sum cancels."""
    ref = mel_ops.log_mel_rows_float64(wp, mats, hop, precision)
    unit = mel_ops.dft_rounding_db(wp, mats, hop, 1).double()
    cancels = unit > 1e-4
    rec = {"values_where_dft_cancels": int(cancels.sum())}
    for name, out in outs.items():
        d = (out.double() - ref).abs()
        rec[f"{name}_vs_f64_max_db"] = d.max().item()
        rec[f"{name}_vs_f64_roundings"] = (d / unit)[cancels].max().item() if cancels.any() else 0.0
    return rec


def reset_launches():
    from uit_mobile_tpu_torch.ops import launches

    for k in launches:
        launches[k] = 0


def cpu_reference(cfg, cpu_model, pcm: np.ndarray, precision: str, top_db_mode,
                  chunk: int = 64) -> np.ndarray:
    """The plain path on the CPU: make_forward_fn with the kernel's plain version."""
    from uit_mobile_tpu_torch.ops import make_forward_fn

    fwd = make_forward_fn(cfg, cpu_model, use_kernel=True, precision=precision,
                          top_db_mode=top_db_mode)
    return np.concatenate([fwd(pcm[i:i + chunk]).numpy() for i in range(0, len(pcm), chunk)])


def phase_serve(cfg, cpu_model, info) -> dict:
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

    rng = np.random.default_rng(1)
    one = pcm_batch(rng, 300, SR)
    three = pcm_batch(rng, 20, 3 * SR)
    clips = [c for c in one] + [c for c in three]
    order = rng.permutation(len(clips))
    svc = TaggingService(cfg, cpu_model, ServiceConfig(dtype="int16"), device="cuda")
    try:
        torch.cuda.synchronize()
        reset_launches()
        submitted, finished, futs = {}, {}, {}
        t0 = time.perf_counter()
        for i in order:
            submitted[i] = time.perf_counter()
            fut = svc.submit(clips[i])
            fut.add_done_callback(lambda f, i=i: finished.__setitem__(i, time.perf_counter()))
            futs[i] = fut
        got = {i: f.result(timeout=300) for i, f in futs.items()}
        t1 = time.perf_counter()
        counts = dict(launches)
    finally:
        svc.close()
    probs = np.stack([got[i] for i in range(len(clips))])
    check(probs.shape == (len(clips), cfg.outputdim), f"serve shape {probs.shape}")
    check(bool(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()),
          "serve probabilities outside [0, 1]")
    want = np.concatenate([cpu_reference(cfg, cpu_model, one, "fast", "per_sample"),
                           cpu_reference(cfg, cpu_model, three, "fast", "per_sample")])
    drift = float(np.abs(probs - want).max())
    check(drift <= 1e-3, f"serve vs CPU plain path drift {drift} > 1e-3")
    check(counts["tfb_fast"] > 0 and counts["row_fast"] > 0,
          f"serving did not launch both fast kernels: {counts}")
    lat = sorted(finished[i] - submitted[i] for i in range(len(clips)))
    rec = {"phase": "serve", "model": "uit_xs", "requests": len(clips),
           "clips_1s": len(one), "clips_3s": len(three), "max_abs_drift_vs_cpu": drift,
           "launches": counts, "clips_per_s": len(clips) / (t1 - t0),
           "p50_latency_ms": 1e3 * lat[len(lat) // 2], "p99_latency_ms": 1e3 * lat[-max(1, len(lat) // 100)],
           "wall_s": t1 - t0, "card": info["nvidia_smi"]}
    emit(rec)
    return counts


def phase_forward(cfg, gpu_model, records, info) -> None:
    """One serving forward per bucket shape on a device-resident batch: its
    device time (CUDA events) beside its host enqueue time and the mel
    kernel's time. Enqueue close to device time means the eager encoder is
    bound by the host issuing its launches."""
    from uit_mobile_tpu_torch.ops import make_forward_fn

    fwd = make_forward_fn(cfg, gpu_model, precision="fast", top_db_mode="per_sample")
    rng = np.random.default_rng(3)
    for variant, B, secs in (("tfb_fast", 256, 1), ("row_fast", 85, 3)):
        x = torch.from_numpy(pcm_batch(rng, B, secs * SR)).to(gpu_model.head.kernel.device)
        forward_ms = time_ms(lambda: fwd(x))
        enqueue = []
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(x)
            enqueue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        mel_ms = records[variant][0]["kernel_ms"]
        emit({"phase": "forward", "model": "uit_xs", "B": B, "seconds": secs,
              "input": "int16", "mel_variant": variant, "forward_ms": forward_ms,
              "enqueue_ms": statistics.median(enqueue), "mel_kernel_ms": mel_ms,
              "mel_share": mel_ms / forward_ms,
              "forward_clips_per_s": B * 1e3 / forward_ms, "card": info["nvidia_smi"]})


def cli_ranking(npz: Path, device: str) -> list:
    wavs = sorted(str(p.relative_to(REPO)) for p in (REPO / "samples").glob("*.wav"))
    out = subprocess.run(
        [sys.executable, "-m", "uit_mobile_tpu_torch.cli.infer", "--kernel",
         "--device", device, "-m", str(npz), "-k", "5", *wavs],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"cli.infer --device {device} failed:\n{out.stderr[-4000:]}")
    rows = [ln.rsplit(None, 1) for ln in out.stdout.splitlines()
            if ln.strip() and not ln.startswith("=====")]
    return [(name.strip(), float(p)) for name, p in rows]


def phase_exact(cfg, cpu_model, gpu_model) -> dict:
    from uit_mobile_tpu_torch.ckpt import save_checkpoint
    from uit_mobile_tpu_torch.ops import launches, make_forward_fn

    rng = np.random.default_rng(2)
    fwd = make_forward_fn(cfg, gpu_model, precision="exact")
    batches = [pcm_batch(rng, B, SR).astype(np.float32) / 32768.0 for B in (4, 256)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fwd(b).cpu().numpy() for b in batches]
    counts = dict(launches)
    drifts = []
    for b, got in zip(batches, outs):
        want = cpu_reference(cfg, cpu_model, b, "exact", None)
        drifts.append(float(np.abs(got - want).max()))
    check(max(drifts) <= 1e-3, f"exact path vs CPU plain path drift {drifts} > 1e-3")
    check(counts["row_exact"] > 0 and counts["tfb_exact"] > 0,
          f"exact path did not launch both exact kernels: {counts}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    npz = OUT_DIR / "uit_xs_seed1234.npz"
    save_checkpoint(npz, cpu_model, cfg)
    gpu_rank, cpu_rank = cli_ranking(npz, "cuda"), cli_ranking(npz, "cpu")
    check([n for n, _ in gpu_rank] == [n for n, _ in cpu_rank],
          "cli --kernel ranking on the card differs from the CPU run")
    cli_drift = max(abs(a - b) for (_, a), (_, b) in zip(gpu_rank, cpu_rank))
    emit({"phase": "exact", "batches": [4, 256], "max_abs_drift_vs_cpu": drifts,
          "launches": counts, "cli_rows": len(gpu_rank), "cli_ranking_equal": True,
          "cli_max_printed_prob_diff": cli_drift})
    return counts


# ---------------------------------------------------------------- training

# configs/train_uit_xs.yaml's recipe as a dict (data in memory, cut to a few
# short epochs); the PSL teacher is MobileNetV2 at its random init because
# its checkpoint is not in the repo (allow_untrained)
RECIPE = {
    "model": "uit_xs", "model_args": {"target_length": 102}, "num_classes": 537,
    "optimizer": "AdamW", "optimizer_args": {"lr": 0.001, "weight_decay": 5e-8},
    "loss": "BCELoss", "loss_args": {}, "batch_size": 32, "chunk_length": 1.0, "mixup": None,
    "epochs": 3, "epoch_length": 10, "warmup_iters": 5, "early_stop": 50, "valid_every": 3,
    "n_saved": 2, "seed": 42, "num_workers": 2, "frontend_precision": "exact",
    "psl": {"model": "MobileNetV2", "pretrained": "checkpoints/mobilenetv2_dm_mAP42_15.npz",
            "allow_untrained": True},
    "wavtransforms": {"Shift": {"min_shift": -0.5, "max_shift": 0.5}, "Gain": {"p": 0.5},
                      "PolarityInversion": {"p": 0.5}},
    "spectransforms": [{"TimeMasking": {"time_mask_param": 20, "iid_masks": True}},
                       {"FrequencyMasking": {"freq_mask_param": 8, "iid_masks": True}},
                       {"FrequencyMasking": {"freq_mask_param": 8, "iid_masks": True}}],
}
# the throughput frontier of configs/train_uit_xs.yaml:57-83 with the encoder
# in float32 (FRONTIER_BF16 adds its bfloat16 lines): tfb_fast in the student
# (B=1024) and the teacher (B=512, through 'tfb_to_bft')
FRONTIER = dict(RECIPE, batch_size=1024, data_dtype="int16", frontend_precision="fast",
                model_args={"target_length": 102, "mel_layout": "tfb"}, wavtransforms={},
                epochs=1, epoch_length=3, valid_every=1, eval_batch_size=64)


def synth_split(rng, n: int, kws: bool):
    """n one-second clips of data/synthworld.py's world: keyword tones
    (labels 527-536) or the class-0 noise filler, as int16 PCM."""
    from uit_mobile_tpu_torch.data.synthworld import synth_clip, synth_labels

    labels = synth_labels(rng, n, kws)
    return [synth_clip(rng, lab) for lab in labels], labels


class ClipDataset:
    """In-memory clips -> (wave, multihot target, name), the datasets'
    contract, with no h5py or pandas; a clip's label is one class or a
    list of classes."""

    def __init__(self, clips, labels, num_classes: int, dtype: str):
        self.clips, self.labels = clips, labels
        self.num_classes, self.dtype = num_classes, dtype

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        from uit_mobile_tpu_torch.data import multihot
        from uit_mobile_tpu_torch.frontend import normalize_pcm16

        wav = self.clips[i] if self.dtype == "int16" else normalize_pcm16(self.clips[i])
        return wav, multihot(np.atleast_1d(self.labels[i]), self.num_classes), f"clip_{i}"


def synth_trainer_class():
    """The port's Trainer with in-memory data from data/synthworld.py, and
    the train step wrapped to keep its metrics. With psl: {mode: offline}
    the AudioSet half is the port's PSLCachedRandomCropHDF5Dataset over
    audioset_train_data, a list of manifest rows whose hdf5path is an
    in-memory {filename: PCM} store."""
    import random

    from uit_mobile_tpu_torch.data import (DataLoader, MultiDataLoader,
                                           PSLCachedRandomCropHDF5Dataset)
    from uit_mobile_tpu_torch.train import Trainer

    class SynthTrainer(Trainer):
        def _build_data(self):
            c = self.config
            rng = np.random.default_rng(c["seed"])
            half, dtype = c["batch_size"] // 2, c.get("data_dtype", "float32")

            def ds(n, kws):
                psl = c.get("psl") or {}
                if not kws and psl.get("mode") == "offline":
                    return PSLCachedRandomCropHDF5Dataset(
                        c["audioset_train_data"], chunk_length=1.0,
                        num_classes=c["num_classes"], cache_path=psl["cache"],
                        rng=random.Random(c["seed"]), dtype=dtype)
                return ClipDataset(*synth_split(rng, n, kws), c["num_classes"], dtype)

            train = MultiDataLoader(**{
                name: DataLoader(ds(2 * half, name == "kws"), batch_size=half, shuffle=True,
                                 drop_last=True, seed=c["seed"], num_workers=2)
                for name in ("kws", "audioset")})
            clips_as, labels_as = synth_split(rng, 32, False)
            clips_kws, labels_kws = synth_split(rng, 32, True)
            test = DataLoader(ClipDataset(clips_as + clips_kws, labels_as + labels_kws,
                                          c["num_classes"], "float32"),
                              batch_size=c.get("eval_batch_size", c["batch_size"]))
            return train, test

        def setup(self):
            super().setup()
            self.metrics = []
            step = self.train_step

            def recorded(batch, generator=None):
                m = step(batch, generator)
                self.metrics.append(m)
                return m

            self.train_step = recorded
            self.start = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            self.teacher_start = ({} if self.psl_model is None else
                                  {k: v.detach().clone()
                                   for k, v in self.psl_model.state_dict().items()})

    return SynthTrainer


def drive_trainer(config: dict, info) -> tuple:
    """Run the Trainer on the card with launch counts set to 0 just before
    and read just after -> (trainer, output npz, counts, record)."""
    import tempfile

    from uit_mobile_tpu_torch.ops import launches

    out_dir = Path(tempfile.mkdtemp(prefix="uit_train_"))
    trainer = synth_trainer_class()(dict(config, outputdir=str(out_dir)), device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    losses = torch.stack([m["total_loss"] for m in trainer.metrics]).cpu()
    norms = torch.stack([m["grad_norm"] for m in trainer.metrics]).cpu()
    check(bool(torch.isfinite(losses).all() and torch.isfinite(norms).all()),
          f"train loss or grad norm not finite: {losses.tolist()}")
    end = trainer.model.state_dict()
    moved = [k for k, v in trainer.start.items() if not torch.equal(v, end[k])]
    params = [k for k, _ in trainer.model.named_parameters()]
    check(all(k in moved for k in params if k not in ("cls_token", "token_pos_embed")),
          f"parameters that did not move: {sorted(set(params) - set(moved))}")
    check("init_bn.mean" in moved and "init_bn.var" in moved, "init_bn buffers did not move")
    teacher_end = {} if trainer.psl_model is None else trainer.psl_model.state_dict()
    check(all(torch.equal(v, teacher_end[k]) for k, v in trainer.teacher_start.items()),
          "the PSL teacher's weights or buffers moved")
    log_text = (out_dir / "train.log").read_text()
    check("Validation Results" in log_text, "no validation ran")
    return trainer, out, counts, {
        "steps": len(trainer.metrics), "B": config["batch_size"], "wall_s": wall,
        "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
        "max_grad_norm_seen": norms.max().item(), "params_moved": len(moved),
        "launches": counts, "output": out.name, "card": info["nvidia_smi"]}


def check_deliverable(out: Path, cfg_expected) -> dict:
    """averaged.npz loads back into the port and serves on the card, within
    1e-3 of the CPU plain path."""
    from uit_mobile_tpu_torch.ckpt import load_model
    from uit_mobile_tpu_torch.ops import make_forward_fn

    cfg, model, extra = load_model(out, device="cuda")
    check(cfg == cfg_expected and "averaged_from" in extra, f"{out.name}: unexpected config")
    _, cpu_model, _ = load_model(out, device="cpu")
    pcm = pcm_batch(np.random.default_rng(6), 16, SR)
    got = make_forward_fn(cfg, model, precision="exact")(pcm).cpu().numpy()
    want = cpu_reference(cfg, cpu_model, pcm, "exact", None)
    drift = float(np.abs(got - want).max())
    check(got.shape == (16, cfg.outputdim) and bool(np.isfinite(got).all()) and drift <= 1e-3,
          f"averaged model serves {got.shape}, drift {drift} from the CPU plain path")
    return {"served": list(got.shape), "max_abs_drift_vs_cpu": drift}


# one train step on the card against the CPU plain path, per configuration:
# B (half AudioSet rows for the teacher), the student's mel layout, frontend
# precision, int16 input, the kernel the step launches in both models, and
# whether the step's own update is also held at 1e-5 over every element
# (step_agreement always holds the card's optimizer fed the CPU's gradients
# there). The frontier's is not: its fast mel sits further from its plain
# version than exact's (on an H100, gradients 6.3e-5 from the CPU's relative
# to each tensor's largest, exact 9.7e-7), and Adam's first step,
# lr * g / (|g| + eps), turns a gradient difference near 0 into up to lr
# (there 3.0e-4 over every element)
PARITY = {"recipe": (32, "bft", "exact", False, "row_exact", True),
          "frontier": (1024, "tfb", "fast", True, "tfb_fast", False)}


def frontend_gate(fe, wav: torch.Tensor, precision: str, layout: str) -> dict:
    """fe(wav) on the card (the kernel) against fe on the CPU (its plain
    version): every value within ops/mel.py:tolerance_db in fe's layout, or
    within the shift of the batch max where top_db clamps against it (the
    shift itself within the tolerance)."""
    from uit_mobile_tpu_torch.frontend import FrontendConfig, reflect_pad
    from uit_mobile_tpu_torch.ops import mel as mel_ops

    got, want = fe(wav), fe(wav.cpu())
    fc = FrontendConfig()
    wp = reflect_pad(wav, fc.n_fft // 2).contiguous()
    mats = mel_ops._matrices(fc, wav.dtype == torch.int16, precision, wav.device)
    tol = mel_ops.tolerance_db(wp, mats, fc.hop_length, precision)
    tol = (tol.permute(1, 2, 0) if layout == "tfb" else tol.transpose(-1, -2)).cpu()
    got = got.cpu()
    shift = (got.max() - want.max()).abs()
    err = (got - want).abs()
    rec = {"shape": list(got.shape), "max_abs_err_db": err.max().item(),
           "max_shift_db": shift.item(),
           "worst_err_over_tolerance": (err / torch.clamp(tol, min=shift)).max().item()}
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and shift <= tol.max() and rec["worst_err_over_tolerance"] <= 1.0,
          f"{layout} {precision} frontend on the card vs the CPU plain path: {rec}")
    return rec


def train_parity(name: str, info, optimizer=("AdamW", {"weight_decay": 5e-8})) -> dict:
    """One train step of a configuration (PSL teacher, AdamW or
    ``optimizer``, constant lr, no augments, no dropout, no mixup) from the
    same weights and batch on the card (the mel kernels) and through the
    plain path on the CPU. Gates: the step's two frontends (frontend_gate)
    and step_agreement (the step's own params too where PARITY says so)."""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step
    from uit_mobile_tpu_torch.utils import resolve_device

    B, layout, precision, int16, variant, all_params = PARITY[name]
    n_as = B // 2
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102, mel_layout=layout)
    t_cfg = models.get_model_config("MobileNetV2", outputdim=527)
    student = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(7), "cpu"))
    teacher = module_to_numpy(models.build(t_cfg, torch.Generator().manual_seed(8), "cpu"))
    rng = np.random.default_rng(9)
    clips_as, _ = synth_split(rng, n_as, False)
    clips_kws, labels = synth_split(rng, B - n_as, True)
    pcm = np.stack(clips_as + clips_kws)
    wav = pcm if int16 else pcm.astype(np.float32) / 32768.0
    target = np.zeros((B, 537), np.float32)
    target[:n_as, 0] = 1.0
    target[np.arange(n_as, B), labels] = 1.0
    fe = make_frontend_fn(cfg.frontend, precision=precision, layout=layout)
    psl_fe = make_frontend_fn(t_cfg.frontend, precision=precision, layout="tfb_to_bft")
    wav_gpu = torch.from_numpy(wav).to(resolve_device("cuda"))
    rec = {"phase": "train_parity", "config": name, "optimizer": optimizer[0], "B": B,
           "teacher_B": n_as,
           "mel_layout": layout, "precision": precision, "input": str(wav.dtype),
           "frontend_student": frontend_gate(fe, wav_gpu, precision, layout),
           "frontend_teacher": frontend_gate(psl_fe, wav_gpu[:n_as], precision, "bft")}

    def fresh(dev):
        model = module_from_numpy(cfg, *student, device=dev)
        return model, build_optimizer(optimizer[0], 1e-3, **optimizer[1]).init(model)

    runs = {}
    for dev_name in ("cuda", "cpu"):
        dev = resolve_device(dev_name)
        model, opt = fresh(dev)
        t_model = module_from_numpy(t_cfg, *teacher, device=dev).requires_grad_(False)
        grads = step_grads(opt)
        step = make_train_step(cfg, model, opt, psl_cfg=t_cfg, psl_model=t_model,
                               psl_split=n_as, frontend_fn=fe, psl_frontend_fn=psl_fe)
        before = dict(launches)
        t0 = time.perf_counter()
        m = step({"wav": torch.from_numpy(wav).to(dev),
                  "target": torch.from_numpy(target).to(dev)})
        loss = m["total_loss"].item()
        rec[f"{dev_name}_step_s"] = time.perf_counter() - t0
        rec[f"{dev_name}_launches"] = {k: launches[k] - before[k] for k in before}
        runs[dev_name] = (loss, m["grad_norm"].item(),
                          {k: v.detach().cpu() for k, v in model.named_parameters()}, grads)
    check(rec["cuda_launches"][variant] == 2,
          f"{name}: the step on the card did not launch {variant} twice: {rec['cuda_launches']}")
    rec.update(step_agreement(runs, fresh, all_params), card=info["nvidia_smi"])
    emit(rec)
    check(rec["agrees"], f"{name}: train step on the card vs CPU plain path: {rec}")
    return rec


def step_grads(opt) -> dict:
    """{name: gradient} of the optimizer's next update, filled in when it
    is applied (the gradients after any clipping)."""
    grads, update = {}, opt.update

    def recorded(g):
        grads.update({n: v.detach().cpu().clone() for n, v in zip(opt.names, g)})
        return update(g)

    opt.update = recorded
    return grads


def step_agreement(runs: dict, fresh, all_params: bool = False) -> dict:
    """One step on the card against the same step on the CPU, runs[device]
    = (loss, pre-clip grad norm, updated params, gradients) -> readings and
    'agrees': loss 1e-4 relative, grad norm 1e-3 relative, every gradient
    within 1e-4 of the CPU's relative to its tensor's largest, and the
    card's optimizer fed the CPU's gradients (``fresh(device)`` -> the
    step's model and optimizer, the factory the caller's runs were built
    with, called anew for the card) within 1e-5 of the CPU's
    updated params over every element (tests/test_torch_steps.py's gate).
    The step's own update is not held element by element unless
    ``all_params``: Adam's first step is lr * g / (|g| + eps), +-lr where
    |g| is near 0 whatever the sign of a rounding; its largest gap and the
    count of elements whose CPU gradient is below 1e-7 are readings."""
    (l_g, n_g, p_g, g_g), (l_c, n_c, p_c, g_c) = runs["cuda"], runs["cpu"]
    model, opt = fresh("cuda")
    opt.update([g_c[n].to(next(model.parameters()).device) for n in opt.names])
    fed = {k: v.detach().cpu() for k, v in model.named_parameters()}
    fed_worst = max((fed[k] - p_c[k]).abs().max().item() for k in p_c)
    worst_all = max((v - p_c[k]).abs().max().item() for k, v in p_g.items())
    small = sum(int(((g.abs() < 1e-7) & (g != 0)).sum()) for g in g_c.values())
    rel = {k: (g_g[k] - g_c[k]).abs() / g_c[k].abs().max().clamp(min=1e-30) for k in g_c}
    worst_grad = max(rel, key=lambda k: rel[k].max().item())
    rec = {
        "loss_gpu": l_g, "loss_cpu": l_c, "loss_rel_err": abs(l_g - l_c) / abs(l_c),
        "grad_norm_gpu": n_g, "grad_norm_cpu": n_c, "grad_norm_rel_err": abs(n_g - n_c) / abs(n_c),
        "params_max_abs_diff": fed_worst,
        "params_gate": "the card's optimizer fed the CPU's gradients, every element"
                       + (", and the step's own update, every element" if all_params else ""),
        "params_max_abs_diff_all": worst_all, "params_small_grad": small,
        "params_total": sum(v.numel() for v in p_g.values()),
        "max_grad_rel_diff": rel[worst_grad].max().item(), "worst_grad_tensor": worst_grad,
        "grad_elements_over_1e-4": int(sum((r > 1e-4).sum() for r in rel.values()))}
    rec["agrees"] = (rec["loss_rel_err"] <= 1e-4 and rec["grad_norm_rel_err"] <= 1e-3
                     and rec["max_grad_rel_diff"] <= 1e-4 and fed_worst <= 1e-5
                     and (worst_all <= 1e-5 or not all_params))
    return rec


def time_train_step(trainer, name: str, info) -> dict:
    """The trainer's step on a fixed device batch: CUDA-event median over 20
    steps after 3 of warm-up, the host's enqueue time of a step, the two mel
    launches (student, teacher) and the teacher's forward, each timed alone
    at the step's shapes."""
    from uit_mobile_tpu_torch import models

    c = trainer.config
    B, n_as = c["batch_size"], c["batch_size"] // 2
    rng = np.random.default_rng(10)
    clips_as, _ = synth_split(rng, n_as, False)
    clips_kws, labels = synth_split(rng, B - n_as, True)
    pcm = np.stack(clips_as + clips_kws)
    dev = trainer.device
    wav = torch.from_numpy(pcm if c.get("data_dtype") == "int16"
                           else pcm.astype(np.float32) / 32768.0).to(dev)
    target = torch.zeros(B, 537, device=dev)
    target[:n_as, 0] = 1.0
    target[torch.arange(n_as, B), torch.tensor(labels)] = 1.0
    batch, gen = {"wav": wav, "target": target}, trainer.generator
    step_ms = time_ms(lambda: trainer.train_step(batch, gen), warmup=3, iters=20)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        enqueue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    # the step feeds the student the augmented float wave when a wav augment
    # is set, and the teacher the raw batch
    s_wav = wav.float() / 32768.0 if (wav.dtype == torch.int16 and c.get("wavtransforms")) else wav
    layout = getattr(trainer.cfg, "mel_layout", "bft")
    gates = {"frontend_student": frontend_gate(trainer.frontend, s_wav,
                                               c["frontend_precision"], layout),
             "frontend_teacher": frontend_gate(trainer.psl_frontend, wav[:n_as],
                                               c["frontend_precision"], "bft")}
    mel_student = time_ms(lambda: trainer.frontend(s_wav))
    mel_teacher = time_ms(lambda: trainer.psl_frontend(wav[:n_as]))

    def teacher():
        with torch.no_grad():
            return models.forward(trainer.psl_cfg, trainer.psl_model, wav[:n_as],
                                  frontend_fn=trainer.psl_frontend)

    teacher_ms = time_ms(teacher)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    teacher()
    teacher_enqueue = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    rec = {"phase": "train_timing", "config": name, "B": B, "teacher_B": n_as,
           "input": str(wav.dtype).replace("torch.", ""),
           "mel_layout": layout, "precision": c["frontend_precision"], **gates,
           "step_ms": step_ms,
           "enqueue_ms": statistics.median(enqueue), "mel_student_ms": mel_student,
           "mel_teacher_ms": mel_teacher, "mel_ms": mel_student + mel_teacher,
           "mel_share": (mel_student + mel_teacher) / step_ms, "teacher_forward_ms": teacher_ms,
           "teacher_share": teacher_ms / step_ms, "teacher_enqueue_ms": teacher_enqueue,
           "clips_per_s": B * 1e3 / step_ms,
           **profile_steps(lambda: trainer.train_step(batch, gen), step_ms),
           "card": info["nvidia_smi"]}
    emit(rec)
    return rec


# kernel name fragments -> the part of the step they belong to (first match)
KERNEL_GROUPS = (("mel", ("mel_kernel",)), ("collective", ("nccl",)),
                 ("conv", ("conv", "cudnn", "implicit", "winograd")),
                 ("matmul", ("gemm", "cutlass", "sm90", "ampere", "cublas")),
                 ("optimizer", ("foreach", "multi_tensor")),
                 ("reduce", ("reduce", "norm", "softmax")))


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def profile_steps(step, step_ms: float, n: int = 5, spans: dict | None = None) -> dict:
    """torch.profiler over n steps: the device's busy time a step (the union
    of its kernels', memcpys' and memsets' intervals), its idle share of the
    CUDA-event step time, the kernels launched a step, and the busy time by
    kind of kernel. ``spans`` {name: device_us(events)} (moe_mlp_span's)
    adds each span's device ms a step and its share of the busy time. None
    where the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = spans or {}
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # a span's record_function range also shows on the device's timeline
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in spans]
    if not dev:
        return {"device_busy_ms": None, "device_idle_share": None, "kernels_per_step": None}
    busy = union_us([(e.time_range.start, e.time_range.end) for e in dev])
    groups: dict = {}
    for e in dev:
        name = e.name.lower()
        kind = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                    "elementwise/other")
        groups[kind] = groups.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / n / 1e3
    busy_ms = busy / n / 1e3
    # not clamped: a busy time above the CUDA-event step shows as a negative
    # share, i.e. the two readings disagree
    out = {"device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / step_ms,
           "kernels_per_step": len(dev) / n,
           "device_ms_by_kind": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    for name, device_us in spans.items():
        out[f"{name}_device_ms"] = device_us(prof.events()) / n / 1e3
        out[f"{name}_share_of_busy"] = out[f"{name}_device_ms"] / busy_ms
    return out


def phase_train(info) -> tuple:
    """The training path on the card: the recipe and the frontier through
    the Trainer (counts set to 0 before each and read after), the recipe's
    deliverable served, one step held against the CPU plain path, and both
    configurations' steps timed. -> ({config: launch counts}, the recipe's
    averaged.npz kept under OUT_DIR)."""
    from uit_mobile_tpu_torch import models

    counts, kept = {}, OUT_DIR / "recipe_averaged.npz"
    for name, config, variant in (("recipe", RECIPE, "row_exact"),
                                  ("frontier", FRONTIER, "tfb_fast")):
        trainer, out, counts[name], rec = drive_trainer(config, info)
        check(counts[name][variant] > 0, f"{name}: the train path never launched {variant}: "
                                         f"{counts[name]}")
        if name == "recipe":
            cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
            rec.update(check_deliverable(out, cfg))
            shutil.copyfile(out, kept)
        emit({"phase": "train", "config": name, **rec})
        time_train_step(trainer, name, info)
        shutil.rmtree(out.parent, ignore_errors=True)
        train_parity(name, info)
    return counts, kept


# ------------------------------------------------------- the rest of training

# the frontier of configs/train_uit_xs.yaml:57-83 with its bfloat16 lines:
# compute_dtype bfloat16 in the encoder and in the teacher
FRONTIER_BF16 = dict(FRONTIER, model_args=dict(FRONTIER["model_args"], compute_dtype="bfloat16"),
                     psl=dict(RECIPE["psl"], compute_dtype="bfloat16"))


def frontier_batch(B: int, int16: bool, seed: int):
    """A [AudioSet filler | keyword] batch on the card with its targets."""
    rng = np.random.default_rng(seed)
    n_as = B // 2
    clips_as, _ = synth_split(rng, n_as, False)
    clips_kws, labels = synth_split(rng, B - n_as, True)
    pcm = np.stack(clips_as + clips_kws)
    wav = torch.from_numpy(pcm if int16 else pcm.astype(np.float32) / 32768.0).cuda()
    target = torch.zeros(B, 537, device="cuda")
    target[:n_as, 0] = 1.0
    target[torch.arange(n_as, B), torch.tensor(labels)] = 1.0
    return {"wav": wav, "target": target}


def phase_bf16(info) -> dict:
    """The bfloat16 frontier through the Trainer (counts set to 0 before and
    read after); its step and the float32 frontier step from the same
    weights on the same batch, CUDA-event medians taken in turns with their
    profiles; drift of one step's loss and of the serving forward against
    float32 (<= 5e-3, > 0); bf16_card_vs_cpu. -> launch counts."""
    import copy

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ops import make_forward_fn
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    trainer, out, counts, rec = drive_trainer(FRONTIER_BF16, info)
    check(counts["tfb_fast"] > 0, f"bf16: the frontier never launched tfb_fast: {counts}")
    check(trainer.cfg.compute_dtype == trainer.psl_cfg.compute_dtype == "bfloat16",
          "bf16: the encoder or the teacher is not in bfloat16")
    shutil.rmtree(out.parent, ignore_errors=True)
    B = FRONTIER_BF16["batch_size"]
    n_as = B // 2
    batch = frontier_batch(B, True, 11)
    steps = {}
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        cfg = dataclasses.replace(trainer.cfg, compute_dtype=dtype)
        t_cfg = dataclasses.replace(trainer.psl_cfg, compute_dtype=dtype)
        model = copy.deepcopy(trainer.model)
        opt = build_optimizer("AdamW", 1e-3, weight_decay=5e-8).init(model)
        steps[name] = make_train_step(cfg, model, opt, psl_cfg=t_cfg, psl_model=trainer.psl_model,
                                      psl_split=n_as, frontend_fn=trainer.frontend,
                                      psl_frontend_fn=trainer.psl_frontend)
    # one step of each from the same weights: the loss drift
    first = {name: step(batch)["total_loss"].item() for name, step in steps.items()}
    ms = {name: [] for name in steps}
    for _ in range(2):  # in turns, so that a clock change hits both
        for name, step in steps.items():
            ms[name].append(time_ms(lambda: step(batch), warmup=2, iters=10))
    step_ms = {name: min(v) for name, v in ms.items()}
    prof = {name: profile_steps(lambda: step(batch), step_ms[name]) for name, step in steps.items()}
    # serving forward, uit_xs at full depth in both dtypes on the card
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
    model = models.build(cfg, torch.Generator().manual_seed(1234), device="cuda")
    pcm = pcm_batch(np.random.default_rng(12), 256, SR)
    probs = {dtype: make_forward_fn(dataclasses.replace(cfg, compute_dtype=dtype), model,
                                    precision="fast")(pcm).cpu()
             for dtype in ("bfloat16", "float32")}
    serve_drift = (probs["bfloat16"] - probs["float32"]).abs().max().item()
    loss_drift = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    rec.update({"phase": "bf16", "config": "frontier_bf16", "B": B, "teacher_B": n_as,
                "step_ms_bf16": step_ms["bf16"], "step_ms_f32": step_ms["f32"],
                "step_ms_rounds": ms, "bf16_step_gain": step_ms["f32"] / step_ms["bf16"] - 1.0,
                "clips_per_s_bf16": B * 1e3 / step_ms["bf16"],
                "clips_per_s_f32": B * 1e3 / step_ms["f32"],
                "device_idle_share_bf16": prof["bf16"]["device_idle_share"],
                "device_idle_share_f32": prof["f32"]["device_idle_share"],
                "device_busy_ms_bf16": prof["bf16"]["device_busy_ms"],
                "device_busy_ms_f32": prof["f32"]["device_busy_ms"],
                "kernels_per_step_bf16": prof["bf16"]["kernels_per_step"],
                "kernels_per_step_f32": prof["f32"]["kernels_per_step"],
                "device_ms_by_kind_bf16": prof["bf16"].get("device_ms_by_kind"),
                "device_ms_by_kind_f32": prof["f32"].get("device_ms_by_kind"),
                "first_loss_bf16": first["bf16"], "first_loss_f32": first["f32"],
                "step_loss_rel_drift": loss_drift, "serve_B": 256,
                "serve_max_abs_drift": serve_drift, "vs_cpu": bf16_card_vs_cpu(trainer)})
    emit(rec)
    check(0 < serve_drift <= 5e-3 and loss_drift <= 5e-3,
          f"bf16 drift against float32: serve {serve_drift}, step loss {loss_drift}")
    vs = rec["vs_cpu"]
    check(vs["student_max_abs"] <= 2e-3 and vs["loss_rel_err"] <= 2e-3
          and 0 < vs["teacher_bf16_drift"] and vs["teacher_max_abs"] <= vs["teacher_drift_cpu"],
          f"bf16 on the card vs bf16 on the CPU: {vs}")
    return counts


def bf16_card_vs_cpu(trainer) -> dict:
    """The bfloat16 frontier's student (uit_xs at full depth) and teacher on
    the card and on the CPU plain path from the same weights at B=64 (teacher
    B=32), the teacher's BNs calibrated on the batch so that its bfloat16
    convs change what it scores: the serving forward's probabilities (2e-3,
    the bfloat16 bound against JAX), one step's loss (2e-3 relative), the
    teacher's bfloat16 drift from its float32 on the card (> 0: bfloat16
    engaged), and the teacher's bfloat16 on the card nearer the CPU's than
    the CPU's bfloat16 is to its float32 (a bfloat16 rounding that flips on
    one side moves the calibrated teacher by up to a few 1e-3)."""
    import copy

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.models.mobilenetv2 import calibrate_bn
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    B, n_as = 64, 32
    batch = frontier_batch(B, True, 25)
    cfg, t_cfg = trainer.cfg, trainer.psl_cfg
    t_f32 = dataclasses.replace(t_cfg, compute_dtype="float32")
    t_model = copy.deepcopy(trainer.psl_model).cpu()
    calibrate_bn(t_f32, t_model, batch["wav"][:n_as].cpu().float() / 32768.0)
    student, teacher = module_to_numpy(trainer.model), module_to_numpy(t_model)
    probs, t_probs, losses, drift = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = module_from_numpy(cfg, *student, device=dev)
        t_model = module_from_numpy(t_cfg, *teacher, device=dev).requires_grad_(False)
        wav = batch["wav"].to(dev)
        probs[dev] = models.apply(cfg, model, wav, frontend_fn=trainer.frontend).float().cpu()
        t_probs[dev] = models.apply(t_cfg, t_model, wav[:n_as],
                                    frontend_fn=trainer.psl_frontend).float().cpu()
        t32 = models.apply(t_f32, t_model, wav[:n_as], frontend_fn=trainer.psl_frontend)
        drift[dev] = (t_probs[dev] - t32.cpu()).abs().max().item()
        opt = build_optimizer("AdamW", 1e-3, weight_decay=5e-8).init(model)
        step = make_train_step(cfg, model, opt, psl_cfg=t_cfg, psl_model=t_model,
                               psl_split=n_as, frontend_fn=trainer.frontend,
                               psl_frontend_fn=trainer.psl_frontend)
        losses[dev] = step({"wav": wav, "target": batch["target"].to(dev)})["total_loss"].item()
    return {"B": B, "teacher_B": n_as,
            "student_max_abs": (probs["cuda"] - probs["cpu"]).abs().max().item(),
            "teacher_max_abs": (t_probs["cuda"] - t_probs["cpu"]).abs().max().item(),
            "teacher_bf16_drift": drift["cuda"], "teacher_drift_cpu": drift["cpu"],
            "loss_gpu": losses["cuda"], "loss_cpu": losses["cpu"],
            "loss_rel_err": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])}


def phase_psl_cache(info) -> tuple:
    """cli.psl_cache's scoring on the card: every grid crop of 64 AudioSet-
    style clips (32 of 1 s, 32 of 10 s, data/synthworld.py's eventful
    clips) through the MobileNetV2 teacher at B=256 and the mel kernel
    (counts set to 0 before and read after). The teacher's BNs are
    calibrated on the clips first (at its init it scores sigmoid(bias)
    whatever the crop), and the cache must vary across clips and between
    neighbouring grid crops by more than its gate. Gates: the teacher's
    frontend at B=256 (frontend_gate), rows of 8 clips against the CPU
    plain teacher (float16 rounding + 1e-3). Then the recipe's Trainer with
    psl: {mode: offline} for 3 steps through the port's dataset on that
    in-memory cache (counts likewise); on 16 of its crops the online
    teacher's scores equal the cached rows (float16 rounding, 5e-4) and
    one offline step's loss the online-PSL step's (the float16 bound,
    1e-3). -> (scoring counts, offline counts)."""
    import random

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.cli.psl_cache import make_teacher_fn
    from uit_mobile_tpu_torch.data import PSLCachedRandomCropHDF5Dataset
    from uit_mobile_tpu_torch.data.psl_cache import score_psl_cache
    from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip
    from uit_mobile_tpu_torch.models.mobilenetv2 import calibrate_bn
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    rng = np.random.default_rng(13)
    clips, labels = [], []
    for i in range(64):
        labs = eventful_labels(rng)
        clips.append((f"as_{i}.wav", synth_eventful_clip(rng, labs, seconds=1.0 if i % 2 else 10.0)))
        labels.append(labs)
    t_cfg = models.get_model_config("MobileNetV2", outputdim=527)
    t_model = models.build(t_cfg, torch.Generator().manual_seed(0), "cpu")
    calib = np.stack([c[:SR] for _, c in clips[:32]]).astype(np.float32) / 32768.0
    t_init = module_to_numpy(calibrate_bn(t_cfg, t_model, torch.from_numpy(calib)))
    teacher = module_from_numpy(t_cfg, *t_init, device="cuda").requires_grad_(False)
    fn = make_teacher_fn(t_cfg, teacher, "exact")
    fn(np.zeros((256, SR), np.int16))  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cache = score_psl_cache(clips, fn, batch_size=256, teacher_name="MobileNetV2 (seed 0)")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score_counts = dict(launches)
    check(score_counts["row_exact"] > 0, f"psl_cache: the teacher never launched row_exact: "
                                         f"{score_counts}")
    crops_256 = np.stack([c[:SR] for _, c in clips[::2][:16]] * 16)
    frontend = frontend_gate(fn.frontend, torch.from_numpy(crops_256).cuda(), "exact", "bft")
    score_ms = time_ms(lambda: fn(crops_256), warmup=2, iters=10)
    score_prof = profile_steps(lambda: fn(crops_256), score_ms)
    sub = clips[:8]
    cpu = score_psl_cache(sub, make_teacher_fn(t_cfg, module_from_numpy(t_cfg, *t_init, "cpu")),
                          batch_size=64, teacher_name="MobileNetV2 (seed 0)")
    worst = max(float(np.abs(cache[k].astype(np.float32) - cpu[k].astype(np.float32)).max())
                for k, _ in sub)
    rows = [cache[k].astype(np.float32) for k, _ in clips]
    crops = sum(r.shape[0] for r in rows)
    # a cache that hardly depends on the crop would pass any gate below
    spread = float(np.concatenate(rows).std(0).mean())
    grid_step = min(float(np.abs(np.diff(r, axis=0)).max(1).min()) for r in rows if len(r) > 1)
    # offline training: the recipe (B=32), AudioSet rows from the cache
    store = dict(clips)
    manifest = [{"filename": k, "labels": labs, "hdf5path": store}
                for (k, _), labs in zip(clips, labels)]
    config = dict(RECIPE, psl={"mode": "offline", "cache": cache}, audioset_train_data=manifest,
                  epochs=1, epoch_length=3, valid_every=1)
    trainer, out, off_counts, rec = drive_trainer(config, info)
    check(trainer.psl_model is None and off_counts["row_exact"] > 0,
          f"offline: a teacher was loaded or the step never launched row_exact: {off_counts}")
    shutil.rmtree(out.parent, ignore_errors=True)
    # the first offline step against the online-PSL step on the same crops
    audioset = PSLCachedRandomCropHDF5Dataset(manifest, 1.0, 537, cache, rng=random.Random(14))
    drawn = [audioset[i] for i in range(16)]
    rng_k = np.random.default_rng(15)
    kws, kws_labels = synth_split(rng_k, 16, True)
    wav = torch.from_numpy(np.concatenate([np.stack([r[0] for r in drawn]),
                                           np.stack(kws).astype(np.float32) / 32768.0])).cuda()
    cached = np.stack([r[1] for r in drawn])
    with torch.no_grad():
        online = models.forward(t_cfg, teacher, wav[:16], frontend_fn=trainer.frontend)
    row_gap = float(np.abs(online.cpu().numpy() - cached[:, :527]).max())
    kws_t = np.zeros((16, 537), np.float32)
    kws_t[np.arange(16), kws_labels] = 1.0
    ground = cached.copy()
    ground[:, :527] = 0.0
    cfg = trainer.cfg
    init = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(16), "cpu"))
    losses = {}
    for mode, target, kw in (("online", np.concatenate([ground, kws_t]),
                              dict(psl_cfg=t_cfg, psl_model=teacher, psl_split=16,
                                   psl_frontend_fn=trainer.frontend)),
                             ("offline", np.concatenate([cached, kws_t]), {})):
        model = module_from_numpy(cfg, *init, device="cuda")
        step = make_train_step(cfg, model, build_optimizer("AdamW", 1e-3).init(model),
                               frontend_fn=trainer.frontend, **kw)
        batch = {"wav": wav, "target": torch.from_numpy(target).cuda()}
        losses[mode] = step(batch)["total_loss"].item()
    offline_ms = time_ms(lambda: step(batch), warmup=2, iters=10)
    offline_prof = profile_steps(lambda: step(batch), offline_ms)
    gap = abs(losses["online"] - losses["offline"])
    emit({"phase": "psl_cache", "clips": 64, "crops": crops, "teacher_B": 256,
          "scoring_s": wall, "crops_per_s": crops / wall, "scoring_launches": score_counts,
          "teacher_frontend": frontend, "teacher_batch_ms": score_ms,
          "teacher_batch": score_prof, "cache_std_over_crops": spread,
          "cache_min_grid_step_diff": grid_step, "cache_vs_cpu_max_abs": worst,
          "cpu_checked_clips": len(sub), "offline_step_ms": offline_ms,
          "offline_step": offline_prof, "offline_trainer": rec,
          "online_teacher_vs_cached_rows": row_gap, "online_loss": losses["online"],
          "offline_loss": losses["offline"], "offline_vs_online_abs": gap,
          "card": info["nvidia_smi"]})
    check(spread > 5e-3 and grid_step > 1e-3 + 5e-4,
          f"psl_cache: the teacher's scores hardly depend on the crop: std {spread}, "
          f"neighbouring grid crops {grid_step}")
    check(worst <= 1e-3 + 5e-4, f"psl_cache on the card vs the CPU teacher: {worst}")
    check(row_gap <= 5e-4, f"offline: cached rows vs the online teacher on their crops: {row_gap}")
    check(gap < 1e-3, f"offline vs online PSL step: {losses}")
    return score_counts, off_counts


# configs/train_sed.yaml as a dict, cut to 2 epochs of 5 steps on in-memory
# eventful clips (its data files are not in the repo)
SED = {"model": "uit_xs", "model_args": {"target_length": 102, "pooling": "dm"},
       "num_classes": 527, "chunk_length": 1.0, "min_overlap": 0.5, "data_dtype": "int16",
       "optimizer": "AdamW", "optimizer_args": {"lr": 0.001, "weight_decay": 5e-8},
       "use_scheduler": True, "warmup_iters": 5, "max_grad_norm": 1.0, "batch_size": 64,
       "epochs": 2, "epoch_length": 5, "threshold": 0.5, "seed": 42, "num_workers": 2,
       "frontend_precision": "exact",
       "wavtransforms": {"Gain": {"p": 0.5}, "PolarityInversion": {"p": 0.5}},
       "spectransforms": [{"TimeMasking": {"time_mask_param": 20}},
                          {"FrequencyMasking": {"freq_mask_param": 8}}]}


class StrongClipDataset:
    """SED windows of in-memory eventful clips: data/hdf5.py's
    strong_window over arrays instead of HDF5 datasets; index-pure windows
    when deterministic."""

    def __init__(self, clips, events, n_segments, seg_seconds, seed, deterministic):
        import random

        self.clips, self.events = clips, events
        self.n_seg, self.seg_s, self.det = n_segments, seg_seconds, deterministic
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        from uit_mobile_tpu_torch.data.hdf5 import strong_window, strong_window_rng

        rng = strong_window_rng(i) if self.det else self.rng
        data, target = strong_window(rng, self.clips[i], self.events[i], SR, SR, self.n_seg,
                                     self.seg_s, 527, 0.5)
        return data, target, f"sed_{i}"


def phase_sed(info) -> dict:
    """cli.train sed's trainer on the card (counts set to 0 before and read
    after): configs/train_sed.yaml's recipe on 128 ten-second eventful clips,
    validation on 32 with index-pure windows, best_sed.npz loaded back and
    run framewise on the card; one SED step (no augments, AdamW) from the
    same weights against the CPU: its frontend on the batch (frontend_gate),
    the loss against the CPU plain path (1e-4 relative), and step_agreement
    (the card's optimizer fed the CPU's gradients) against the
    CPU fed the card's mel. The plain mel differs from the kernel's within
    its tolerance, and that difference alone flips enough ReLUs to move
    this step's fc1 gradients by ~1e-3 of their largest on the CPU (1e-6
    dB of noise on the mel: 6e-4), so the gradients are held after the
    frontend and the frontend on its own. -> launch counts."""
    import tempfile

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import load_model, module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.train import build_optimizer
    from uit_mobile_tpu_torch.train.sed import segment_geometry, train_sed_from_config
    from uit_mobile_tpu_torch.train.steps import make_framewise_train_step

    cfg = models.get_model_config("uit_xs", outputdim=527, target_length=102, pooling="dm")
    n_seg, seg_s = segment_geometry(cfg)
    rng = np.random.default_rng(17)

    def world(n, seed, det):
        clips, events = [], []
        for _ in range(n):
            ev = []
            clips.append(synth_eventful_clip(rng, eventful_labels(rng), events=ev))
            events.append(ev)
        return StrongClipDataset(clips, events, n_seg, seg_s, seed, det)

    train_ds, eval_ds = world(128, 18, False), world(32, 19, True)
    out_dir = Path(tempfile.mkdtemp(prefix="uit_sed_"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    best = train_sed_from_config(dict(SED, outputdir=str(out_dir)), device="cuda",
                                 train_dataset=train_ds, eval_dataset=eval_ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    check(counts["row_exact"] > 0, f"sed: the SED path never launched row_exact: {counts}")
    log_text = (out_dir / "train.log").read_text()
    f1 = [ln.split("segF1 micro")[1].split()[0] for ln in log_text.splitlines()
          if "segF1 micro" in ln]
    check(len(f1) == 2 and best.exists(), f"sed: validations {f1}, {best}")
    b_cfg, b_model, extra = load_model(best, device="cuda")
    pcm = np.stack([train_ds.clips[i][:SR] for i in range(4)])
    fw, times = models.apply_framewise(b_cfg, b_model, torch.from_numpy(pcm).cuda(),
                                       frontend_fn=make_frontend_fn(b_cfg.frontend))
    check(tuple(fw.shape) == (4, n_seg, 527) and bool(torch.isfinite(fw).all()),
          f"sed: best_sed.npz framewise {tuple(fw.shape)}")
    shutil.rmtree(out_dir, ignore_errors=True)
    # one step on the card against the CPU plain path
    init = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(20), "cpu"))
    rows = [train_ds[i] for i in range(64)]
    batch = {"wav": torch.from_numpy(np.stack([r[0] for r in rows])),
             "target": torch.from_numpy(np.stack([r[1] for r in rows]))}
    fe = make_frontend_fn(cfg.frontend, precision="exact")
    card_batch = {k: v.cuda() for k, v in batch.items()}
    frontend = frontend_gate(fe, card_batch["wav"], "exact", "bft")
    card_mel = fe(card_batch["wav"]).cpu()
    runs, steps = {}, {}

    def fresh(dev):
        model = module_from_numpy(cfg, *init, device=dev)
        return model, build_optimizer("AdamW", 1e-3).init(model)

    # the CPU step twice: through the plain mel (the whole step) and through
    # the card's mel (the step after the frontend)
    for run, dev, run_fe in (("cuda", "cuda", fe), ("cpu", "cpu", fe),
                             ("cpu_card_mel", "cpu", lambda w: card_mel)):
        model, opt = fresh(dev)
        grads = step_grads(opt)
        steps[run] = make_framewise_train_step(cfg, model, opt, max_grad_norm=1.0,
                                               frontend_fn=run_fe)
        m = steps[run]({k: v.to(dev) for k, v in batch.items()})
        runs[run] = (m["total_loss"].item(), m["grad_norm"].item(),
                     {k: v.detach().cpu() for k, v in model.named_parameters()}, grads)
    whole = step_agreement(runs, fresh)
    agree = step_agreement(dict(runs, cpu=runs["cpu_card_mel"]), fresh)
    step_ms = time_ms(lambda: steps["cuda"](card_batch), warmup=2, iters=10)
    prof = profile_steps(lambda: steps["cuda"](card_batch), step_ms)
    emit({"phase": "sed", "B": 64, "steps": 10, "wall_s": wall, "launches": counts,
          "segment_f1_micro_by_epoch": [float(x) for x in f1], "best_epoch": extra["epoch"],
          "best_sed_framewise": list(fw.shape), "frontend": frontend,
          "step_vs_cpu_plain": whole, "step_vs_cpu_on_card_mel": agree,
          "step_ms": step_ms, "clips_per_s": 64e3 / step_ms, **prof,
          "card": info["nvidia_smi"]})
    check(whole["loss_rel_err"] <= 1e-4 and agree["agrees"],
          f"sed step on the card vs the CPU: {whole}, on the card's mel {agree}")
    return counts


# configs/pretrain_mae.yaml as a dict, cut to 5 steps on in-memory clips
MAE = {"model": "uit_xs", "model_args": {"target_length": 1012}, "mask_ratio": 0.75,
       "decoder_depth": 2, "batch_size": 64, "epochs": 1, "epoch_length": 5, "warmup_iters": 5,
       "optimizer": "AdamW", "optimizer_args": {"lr": 0.00015, "weight_decay": 5e-8},
       "num_workers": 2, "seed": 42}


class UnlabeledClipDataset:
    """MAE crops of in-memory clips: float32 waves of the window length."""

    def __init__(self, clips):
        self.clips = clips

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        from uit_mobile_tpu_torch.frontend import normalize_pcm16

        return normalize_pcm16(self.clips[i]), np.zeros(527, np.float32), f"u_{i}"


def phase_pretrain(info) -> dict:
    """cli.train pretrain's trainer on the card (counts set to 0 before and
    read after; its frontend is the plain rfft one, as in the JAX package):
    configs/pretrain_mae.yaml's recipe on 64 in-memory 10.12 s clips; one
    MAE forward on the card against the CPU with the same noise (loss 1e-4
    relative); the snapshot into a 102-frame Trainer's pretrained: load on
    the card and on the CPU (equal). -> launch counts."""
    import tempfile

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import module_to_numpy
    from uit_mobile_tpu_torch.ckpt.convert import load_numpy
    from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.train import Trainer
    from uit_mobile_tpu_torch.train import pretrain as mae

    rng = np.random.default_rng(21)
    n = int(1012 * 160) + 160  # the window of target_length 1012
    clips = [synth_eventful_clip(rng, eventful_labels(rng), seconds=n / SR) for _ in range(64)]
    out_dir = Path(tempfile.mkdtemp(prefix="uit_mae_"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    snap = mae.pretrain_from_config(dict(MAE, outputpath=str(out_dir)), device="cuda",
                                    dataset=UnlabeledClipDataset(clips))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    check(snap.exists(), f"pretrain: no snapshot at {snap}")
    # one forward on the card and on the CPU, same weights, batch and noise
    enc = models.get_model_config("uit_xs", outputdim=527, target_length=1012)
    cfg = mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=2)
    init = module_to_numpy(mae.init(cfg, torch.Generator().manual_seed(22)))
    wav = torch.from_numpy(np.stack([UnlabeledClipDataset(clips)[i][0] for i in range(64)]))
    noise = torch.rand((64, cfg.num_patches), generator=torch.Generator().manual_seed(23))
    losses = {}
    for dev in ("cuda", "cpu"):
        model = load_numpy(mae.MAE(cfg), *init).to(dev)
        with torch.no_grad():
            losses[dev] = mae.forward(cfg, model, wav.to(dev), noise=noise.to(dev))[0].item()
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    from uit_mobile_tpu_torch.train import build_optimizer

    model = load_numpy(mae.MAE(cfg), *init).to("cuda")
    step = mae.make_mae_step(cfg, model, build_optimizer("AdamW", 1.5e-4).init(model))
    card_wav, gen = wav.cuda(), torch.Generator(device="cuda").manual_seed(24)
    step_ms = time_ms(lambda: step(card_wav, gen), warmup=2, iters=10)
    prof = profile_steps(lambda: step(card_wav, gen), step_ms)
    # the snapshot into a 102-frame student, on the card and on the CPU
    loaded = {}
    for dev in ("cuda", "cpu"):
        t = Trainer.__new__(Trainer)
        t.config = {"model": "uit_xs", "num_classes": 537, "seed": 0,
                    "model_args": {"target_length": 102}, "pretrained": str(snap)}
        t.device = torch.device(dev)
        loaded[dev] = {k: v.detach().cpu() for k, v in t._build_model()[1].named_parameters()}
    load_diff = max((loaded["cuda"][k] - loaded["cpu"][k]).abs().max().item() for k in loaded["cpu"])
    tpe = tuple(loaded["cuda"]["time_pos_embed"].shape)
    emit({"phase": "pretrain", "B": 64, "steps": 5, "target_length": 1012, "wall_s": wall,
          "launches": counts, "first_loss_gpu": losses["cuda"],
          "first_loss_cpu": losses["cpu"], "loss_rel_err": rel,
          "step_ms": step_ms, "clips_per_s": 64e3 / step_ms, **prof,
          "finetune_time_pos_embed": list(tpe), "finetune_load_max_abs_diff": load_diff,
          "card": info["nvidia_smi"]})
    shutil.rmtree(out_dir, ignore_errors=True)
    check(rel <= 1e-4 and load_diff == 0.0 and tpe == (6, 128),
          f"pretrain on the card vs the CPU: loss {losses}, load diff {load_diff}, {tpe}")
    return counts


# ------------------------------------------------------ deployable artifacts

# (artifact, B, input dtype, precision, the kernel its program launches): the
# serving shape (int16 fast, the transposed kernel), exported here, and the
# exact path's B=4, exported by cli.export --artifact --kernel --verify
EXPORTS = (("serving", 256, "int16", "fast", "tfb_fast"),
           ("exact", 4, "float32", "exact", "row_exact"))


def phase_export(cfg, cpu_model, info) -> dict:
    """The deployable artifact of uit_xs (ckpt/artifact.py) on the card: each
    of EXPORTS exported with the kernel at a fixed batch (the exact one by
    cli.export --artifact --kernel --verify from the seed-1234 checkpoint),
    written, reloaded from its file and called (counts set to 0 just before
    each call and read just after: its kernel once, no other); held bitwise
    or within 1e-6 of make_forward_fn on the card and within 1e-3 of the
    CPU plain path. One batch-polymorphic plain artifact of 3 s clips
    served through TaggingService.from_artifact on the card, 1 s clips
    (right-zero-padded to its bucket) and 3 s clips, within 1e-3 of the
    CPU's plain forward of the padded clips. cli.export -o x.pt and
    cli.average in this process. -> summed launch counts."""
    from uit_mobile_tpu_torch.ckpt.artifact import export_serving, load_artifact, save_artifact
    from uit_mobile_tpu_torch.cli.average import main as average_main
    from uit_mobile_tpu_torch.cli.export import main as export_main
    from uit_mobile_tpu_torch.ops import launches, make_forward_fn
    from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

    rng = np.random.default_rng(30)
    gpu_model = copy.deepcopy(cpu_model).cuda().eval()
    counts = {k: 0 for k in launches}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    npz = OUT_DIR / "uit_xs_seed1234.npz"
    for name, B, dtype, precision, variant in EXPORTS:
        path = OUT_DIR / f"uit_xs_{name}.uitx"
        t0 = time.perf_counter()
        if name == "exact":
            cli_stdout(export_main, [str(npz), "-o", str(path), "--artifact", "--kernel",
                                     "--batch-size", str(B), "--dtype", dtype,
                                     "--precision", precision, "--verify"])
        else:
            save_artifact(path, export_serving(cfg, cpu_model, batch_size=B, dtype=dtype,
                                               precision=precision, use_kernel=True,
                                               device="cuda"), cfg=cfg)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn, meta = load_artifact(path)
        load_s = time.perf_counter() - t0
        pcm = pcm_batch(rng, B, SR)
        wav = pcm if dtype == "int16" else pcm.astype(np.float32) / 32768.0
        x = torch.from_numpy(wav).cuda()
        torch.cuda.synchronize()
        reset_launches()
        got = fn(x)
        torch.cuda.synchronize()
        run = dict(launches)
        for k, v in run.items():
            counts[k] += v
        fwd = make_forward_fn(cfg, gpu_model, use_kernel=True, precision=precision,
                              top_db_mode="per_sample")
        card = (got - fwd(x)).abs().max().item()
        cpu = float(np.abs(got.cpu().numpy()
                           - cpu_reference(cfg, cpu_model, wav, precision, "per_sample")).max())
        rec = {"phase": "export", "artifact": name, "B": B, "input": dtype,
               "precision": precision, "launches": run,
               "exported_by": "cli.export --verify" if name == "exact" else "export_serving",
               "export_s": export_s, "load_s": load_s,
               "file_bytes": path.stat().st_size, "max_abs_diff_vs_forward_on_card": card,
               "max_abs_drift_vs_cpu": cpu, "call_ms": time_ms(lambda: fn(x)),
               "make_forward_fn_ms": time_ms(lambda: fwd(x)), "card": info["nvidia_smi"]}
        emit(rec)
        check(meta["use_kernel"] and meta["input_shape"] == [str(B), str(SR)],
              f"export {name}: meta {meta['input_shape']}")
        check(run[variant] == 1 and sum(run.values()) == 1,
              f"export {name}: the reloaded artifact did not launch {variant} once: {run}")
        check(card <= 1e-6 and cpu <= 1e-3,
              f"export {name}: {card} from make_forward_fn on the card, {cpu} from the CPU")
    # a batch-polymorphic plain artifact behind TaggingService.from_artifact
    t0 = time.perf_counter()
    exported = export_serving(cfg, cpu_model, n_samples=3 * SR, dtype="int16", device="cuda")
    export_s = time.perf_counter() - t0
    path = save_artifact(OUT_DIR / "uit_xs_poly_3s.uitx", exported, cfg=cfg,
                         labels={"0": "Speech"})
    clips = list(pcm_batch(rng, 32, SR)) + list(pcm_batch(rng, 16, 3 * SR))
    svc = TaggingService.from_artifact(path, ServiceConfig(batch_size=16, dtype="int16"))
    try:
        check(svc.artifact_meta["labels"] == {"0": "Speech"} and svc.cfg.max_seconds == 3,
              f"from_artifact: {svc.cfg}")
        got = np.stack(svc.infer_many(clips))
    finally:
        svc.close()
    padded = np.stack([np.pad(c, (0, 3 * SR - len(c))) for c in clips])
    want = make_forward_fn(cfg, cpu_model, use_kernel=False,
                           top_db_mode="per_sample")(padded).numpy()
    drift = {f"{secs}s": float(np.abs(got[sl] - want[sl]).max())
             for secs, sl in ((1, slice(0, 32)), (3, slice(32, None)))}
    emit({"phase": "export", "artifact": "poly_3s", "served_clips": {"1s": 32, "3s": 16},
          "export_s": export_s, "file_bytes": path.stat().st_size,
          "max_abs_drift_vs_cpu": drift, "card": info["nvidia_smi"]})
    check(got.shape == (len(clips), cfg.outputdim) and max(drift.values()) <= 1e-3,
          f"from_artifact 1 s and 3 s clips: {got.shape}, drift {drift} from the CPU")
    t0 = time.perf_counter()
    cli_stdout(export_main, [str(npz), "-o", str(OUT_DIR / "cli.pt")])
    cli_stdout(average_main, [str(npz), str(npz), "-o", str(OUT_DIR / "cli_avg.npz")])
    pt = torch.load(OUT_DIR / "cli.pt")
    check("patch_embed.proj.weight" in pt, f"cli.export .pt keys {sorted(pt)[:4]}")
    emit({"phase": "export", "clis": ["export -o .pt", "average"],
          "wall_s": time.perf_counter() - t0})
    return counts


# --------------------------------------------------------------------- MoE

MOE_B = 32  # clips of 10 s (target_length 1012: 252 tokens a clip)


def moe_batch(seed: int):
    """(MOE_B, 10 s) int16 eventful clips of data/synthworld.py and their
    multihot targets (537 classes)."""
    from uit_mobile_tpu_torch.data import multihot
    from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip

    rng = np.random.default_rng(seed)
    labels = [eventful_labels(rng) for _ in range(MOE_B)]
    pcm = np.stack([synth_eventful_clip(rng, lab) for lab in labels])
    return pcm, np.stack([multihot(lab, 537) for lab in labels])


def record_routing(moe_mod, sink: list):
    """Wrap models/moe.py's _top_k so that each call's expert indices are
    appended to ``sink`` (on the CPU) -> a function that restores it."""
    orig = moe_mod._top_k

    def recorded(gates, k):
        values, idx = orig(gates, k)
        sink.append(idx.detach().cpu())
        return values, idx

    moe_mod._top_k = recorded
    return lambda: setattr(moe_mod, "_top_k", orig)


def expert_relu(moe_mod, record: list | None = None, masks: list | None = None):
    """Route the experts' ReLU (models/moe.py looks it up in ACTIVATIONS at
    each call; nothing else in uit_xs_moe does) through a wrapper, one call
    a block in forward order: ``record`` gets each call's input on the CPU;
    ``masks`` (one bool tensor a call) replace the sign test, so that the
    input and its gradient pass where the mask is set -> a function that
    restores the table."""
    table, relu = moe_mod.ACTIVATIONS, moe_mod.ACTIVATIONS["relu"]
    forced = iter(masks or ())

    def wrapped(x):
        if record is not None:
            record.append(x.detach().cpu())
        if masks is None:
            return relu(x)
        return torch.where(next(forced).to(x.device), x, torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))

    table["relu"] = wrapped
    return lambda: table.__setitem__("relu", relu)


def relu_flips(a: list, b: list) -> dict:
    """The experts' ReLU inputs of two runs (one tensor a block) -> how many
    fall on different sides of 0, the largest |input| among those on either
    run, and the largest |input| of all."""
    n, near = 0, 0.0
    for x, y in zip(a, b):
        d = (x > 0) != (y > 0)
        n += int(d.sum())
        if d.any():
            near = max(near, x[d].abs().max().item(), y[d].abs().max().item())
    return {"relu_inputs": sum(x.numel() for x in a), "relu_sign_flips": n,
            "relu_flip_max_abs_input": near,
            "relu_max_abs_input": max(x.abs().max().item() for x in a)}


def moe_mlp_span(moe_mod):
    """Wrap models/moe.py's moe_mlp (block_forward looks it up at each call)
    in a record_function range, and note the autograd nodes of each call
    (those between its outputs and its input, by name and sequence number)
    -> (restore, device_us): device_us(profiler events) is the device's busy
    time inside the ranges' device-side intervals (the forward) plus the
    device time of those nodes (their backward). The forward is read on the
    device's timeline: the ranges' device_time_total, summed over the CPU
    op tree, read up to 6.5 % over the kernels inside them on the H100."""
    from torch.autograd import DeviceType

    orig, nodes = moe_mod.moe_mlp, set()

    def wrapped(cfg, p, x):
        with torch.profiler.record_function("moe_mlp"):
            y, aux = orig(cfg, p, x)
        key = lambda fn: (fn.name(), fn._sequence_nr())  # noqa: E731
        todo, seen = [y.grad_fn, aux.grad_fn], set()
        stop = None if x.grad_fn is None else key(x.grad_fn)
        while todo:
            fn = todo.pop()
            if fn is None or key(fn) == stop or key(fn) in seen:
                continue
            seen.add(key(fn))
            if "AccumulateGrad" not in fn.name():
                nodes.add(key(fn))
            todo.extend(f for f, _ in fn.next_functions)
        return y, aux

    def device_us(events) -> float:
        ranges, kernels = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                (ranges if e.name == "moe_mlp" else kernels).append(
                    (e.time_range.start, e.time_range.end))
        forward = union_us([(max(a, s), min(b, t)) for a, b in kernels for s, t in ranges
                            if min(b, t) > max(a, s)])
        return forward + sum(e.device_time_total for e in events
                             if e.device_type == DeviceType.CPU
                             and (e.name, e.sequence_nr) in nodes)

    moe_mod.moe_mlp = wrapped
    return (lambda: setattr(moe_mod, "moe_mlp", orig)), device_us


def profile_moe(moe_mod, step, step_ms: float) -> dict:
    """profile_steps over 3 steps with moe_mlp's span: its device time a
    step and its share of the device's busy time."""
    restore, device_us = moe_mlp_span(moe_mod)
    try:
        prof = profile_steps(step, step_ms, n=3, spans={"moe_mlp": device_us})
    finally:
        restore()
    share = prof.get("moe_mlp_share_of_busy")
    check(share is None or 0.0 < share <= 1.0, f"moe_mlp's share of the busy time: {share}")
    return prof


def phase_moe(info) -> dict:
    """uit_xs_moe at full width (D=128, depth 12, 8 experts, top-2, capacity
    2.0, target_length 1012, outputdim 537) on the card, counts set to 0
    just before each path and read just after:
      serve - make_forward_fn with the kernel at B=32 x 10 s int16 exact
              (row_exact through 'tfb_to_bft'), within 1e-3 of the CPU plain
              path; profiled, moe_mlp's share of the busy time;
      train - 5 make_moe_train_step steps (B=32 x 10 s, AdamW, the exact
              kernel), timed and profiled (moe_mlp's share), peak memory;
              one step from the same weights held against the CPU with the
              frontend (frontend_gate) and the step after it gated apart,
              as the SED phase does, the tokens whose experts differ and
              the experts' ReLU inputs whose sign differs counted;
      adafactor - 3 recipe steps through the Trainer with optimizer
              Adafactor, one step held against the CPU (train_parity).
    -> {path: launch counts}."""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.models import moe
    from uit_mobile_tpu_torch.ops import launches, make_forward_fn
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.parallel import make_moe_train_step
    from uit_mobile_tpu_torch.train import build_optimizer

    cfg = models.get_model_config("uit_xs_moe", outputdim=537, target_length=1012)
    init = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(40), "cpu"))
    cpu_model = module_from_numpy(cfg, *init, device="cpu")
    gpu_model = module_from_numpy(cfg, *init, device="cuda")
    counts = {}
    # serve
    pcm, target = moe_batch(41)
    x = torch.from_numpy(pcm).cuda()
    fwd = make_forward_fn(cfg, gpu_model, use_kernel=True, precision="exact")
    torch.cuda.synchronize()
    reset_launches()
    probs = fwd(x)
    torch.cuda.synchronize()
    counts["serve"] = dict(launches)
    want = cpu_reference(cfg, cpu_model, pcm, "exact", None, chunk=MOE_B)
    serve_drift = float(np.abs(probs.cpu().numpy() - want).max())
    forward_ms = time_ms(lambda: fwd(x), warmup=1, iters=5)
    rec = {"phase": "moe", "path": "serve", "B": MOE_B, "seconds": 10, "input": "int16",
           "precision": "exact", "launches": counts["serve"], "max_abs_drift_vs_cpu": serve_drift,
           "forward_ms": forward_ms, "clips_per_s": MOE_B * 1e3 / forward_ms,
           **profile_moe(moe, lambda: fwd(x), forward_ms), "card": info["nvidia_smi"]}
    emit(rec)
    check(probs.shape == (MOE_B, 537) and serve_drift <= 1e-3,
          f"moe serve: {tuple(probs.shape)}, drift {serve_drift} from the CPU plain path")
    check(counts["serve"]["row_exact"] == 1, f"moe serve did not launch row_exact: {counts['serve']}")
    # train
    fe = make_frontend_fn(cfg.frontend, precision="exact", layout="bft")

    def fresh(dev):
        m = module_from_numpy(cfg, *init, device=dev).train()
        return m, build_optimizer("AdamW", 1e-3, weight_decay=5e-8).init(m)

    model, opt = fresh("cuda")
    step = make_moe_train_step(cfg, model, opt, frontend_fn=fe)
    t = torch.from_numpy(target).cuda()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    metrics = [step(x, t) for _ in range(5)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["train"] = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["total_loss"].item() for m in metrics]
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, start[k])]
    check(counts["train"]["row_exact"] == 5 and all(np.isfinite(losses)),
          f"moe train: launches {counts['train']}, losses {losses}")
    last = f"blocks.{cfg.base.depth - 1}.moe"
    check("init_bn.mean" in moved and f"{last}.router.kernel" in moved
          and f"{last}.fc2.kernel" in moved,
          f"moe train: moved {len(moved)} tensors")
    step_ms = time_ms(lambda: step(x, t), warmup=1, iters=5)
    prof = profile_moe(moe, lambda: step(x, t), step_ms)
    # one step on the card against the CPU, from the same weights: through
    # the plain mel (the whole step), through the card's mel (the step after
    # the frontend), and through the card's mel and the card's expert ReLU
    # signs (the step after the frontend but for the ReLUs whose input the
    # two devices' sums put on different sides of 0)
    pcm1, target1 = moe_batch(43)
    batch = (torch.from_numpy(pcm1), torch.from_numpy(target1))
    frontend = frontend_gate(fe, batch[0].cuda(), "exact", "bft")
    card_mel = fe(batch[0].cuda()).cpu()
    runs, routes, relu_in, run_s = {}, {}, {"cuda": [], "cpu_card_mel": []}, {}
    for run, dev, run_fe in (("cuda", "cuda", fe), ("cpu", "cpu", fe),
                             ("cpu_card_mel", "cpu", lambda w: card_mel),
                             ("cpu_card_mel_card_relu", "cpu", lambda w: card_mel)):
        m, o = fresh(dev)
        grads = step_grads(o)
        routes[run] = []
        masks = [v > 0 for v in relu_in["cuda"]] if run.endswith("card_relu") else None
        restores = (record_routing(moe, routes[run]),
                    expert_relu(moe, record=relu_in.get(run), masks=masks))
        t0 = time.perf_counter()
        try:
            r = make_moe_train_step(cfg, m, o, frontend_fn=run_fe)(*(v.to(dev) for v in batch))
            runs[run] = (r["total_loss"].item(), r["grad_norm"].item(),
                         {k: v.detach().cpu() for k, v in m.named_parameters()}, grads)
        finally:
            for restore in restores:
                restore()
        run_s[run] = time.perf_counter() - t0

    def flips(a, b):  # tokens whose chosen experts differ, summed over the blocks
        return int(sum((x != y).any(-1).sum() for x, y in zip(routes[a], routes[b])))

    whole = step_agreement(runs, fresh)
    after = step_agreement(dict(runs, cpu=runs["cpu_card_mel"]), fresh)
    masked = step_agreement(dict(runs, cpu=runs["cpu_card_mel_card_relu"]), fresh)
    rec = {"phase": "moe", "path": "train", "B": MOE_B, "steps": 5, "optimizer": "AdamW",
           "launches": counts["train"], "losses": losses, "wall_s": wall, "step_ms": step_ms,
           "clips_per_s": MOE_B * 1e3 / step_ms, "peak_memory_bytes": peak, **prof,
           "frontend": frontend, "step_vs_cpu_plain": whole, "step_vs_cpu_on_card_mel": after,
           "step_vs_cpu_on_card_mel_and_relu_signs": masked,
           "relu_card_vs_cpu_on_card_mel": relu_flips(relu_in["cuda"], relu_in["cpu_card_mel"]),
           "routing_decisions": int(sum(r.shape[0] * r.shape[1] for r in routes["cuda"])),
           "tokens_routed_differently_vs_cpu_plain": flips("cuda", "cpu"),
           "tokens_routed_differently_vs_cpu_on_card_mel": flips("cuda", "cpu_card_mel"),
           "tokens_routed_differently_vs_cpu_on_card_mel_and_relu_signs":
               flips("cuda", "cpu_card_mel_card_relu"),
           "parity_run_s": run_s, "card": info["nvidia_smi"]}
    emit(rec)
    # After the frontend the routing must be identical. Every gate of
    # step_agreement holds once the CPU takes the card's ReLU signs; without
    # them the gradients are held at 1e-3 of their tensor's largest: an
    # expert's ReLU input that the two devices' sums put on either side of
    # 0 moves that slot's share of its expert's fc1/fc2 gradient, and an
    # expert sums at most C = 1,008 slots where the dense MLP sums 8,064
    # tokens (relu_card_vs_cpu_on_card_mel counts those inputs).
    check(whole["loss_rel_err"] <= 1e-4 and masked["agrees"]
          and after["loss_rel_err"] <= 1e-4 and after["grad_norm_rel_err"] <= 1e-3
          and after["max_grad_rel_diff"] <= 1e-3 and after["params_max_abs_diff"] <= 1e-5
          and rec["tokens_routed_differently_vs_cpu_on_card_mel"] == 0
          and rec["tokens_routed_differently_vs_cpu_on_card_mel_and_relu_signs"] == 0,
          f"moe step on the card vs the CPU: {whole}, on the card's mel {after}, "
          f"and its ReLU signs {masked}")
    # Adafactor through the Trainer: 3 recipe steps, one step against the CPU
    trainer, out, counts["adafactor"], trec = drive_trainer(ADAFACTOR, info)
    check(counts["adafactor"]["row_exact"] > 0,
          f"adafactor: the train path never launched row_exact: {counts['adafactor']}")
    emit({"phase": "moe", "path": "adafactor", **trec})
    shutil.rmtree(out.parent, ignore_errors=True)
    train_parity("recipe", info, optimizer=("Adafactor", {}))
    return counts


# configs/train_uit_xs.yaml's recipe with optimizer Adafactor, cut to 3 steps
ADAFACTOR = dict(RECIPE, optimizer="Adafactor", optimizer_args={"lr": 0.001}, epochs=1,
                 epoch_length=3, valid_every=1)


# ---------------------------------------------------------------- evaluation

# what `cli.train run` evaluates, as the names of the in-memory sets
EVAL_RUN_CONFIG = {"kws_test_data": "gsc", "audioset_eval_data": "audioset"}


def eval_sets(rng) -> dict:
    """In-memory clips of data/synthworld.py -> {set: (int16 clips, labels)}:
    'gsc' 64 one-second clips (32 keywords, 32 filler), label lists;
    'audioset' 64 ten-second clips of ten 1 s clips each (a keyword in ~30 %
    of the seconds), the labels they carry; 'strong' 16 such clips, their
    keyword seconds as (class, onset, offset) events."""
    from uit_mobile_tpu_torch.data.synthworld import synth_clip, synth_labels

    kw_clips, kw_labels = synth_split(rng, 32, True)
    fi_clips, fi_labels = synth_split(rng, 32, False)
    sets = {"gsc": (kw_clips + fi_clips, [[lab] for lab in kw_labels + fi_labels])}

    def long_clips(n):
        labels = [[synth_labels(rng, 1, rng.uniform() < 0.3)[0] for _ in range(10)]
                  for _ in range(n)]
        return [np.concatenate([synth_clip(rng, lab) for lab in ls]) for ls in labels], labels

    clips, labels = long_clips(64)
    sets["audioset"] = (clips, [sorted(set(ls)) for ls in labels])
    clips, labels = long_clips(16)
    sets["strong"] = (clips, [[(lab, float(i), float(i + 1)) for i, lab in enumerate(ls) if lab]
                              for ls in labels])
    return sets


def synth_evaluator_class(sets: dict):
    """The port's Evaluator reading the in-memory sets through its one data
    method, and keeping every epoch's (preds, targets, names)."""
    from uit_mobile_tpu_torch.evaluate import Evaluator
    from uit_mobile_tpu_torch.frontend import normalize_pcm16

    class SynthEvaluator(Evaluator):
        def __init__(self, *args, **kw):
            super().__init__(*args, num_workers=1, report_dir=str(OUT_DIR), **kw)
            self.epochs = []

        def _clips(self, eval_data, num_classes, basename=True, strong=False):
            clips, labels = sets[eval_data]
            if not strong:
                return ClipDataset(clips, labels, num_classes, self.dtype)
            conv = (lambda w: w) if self.dtype == "int16" else normalize_pcm16
            return [(f"{eval_data}_{i}", conv(c), events)
                    for i, (c, events) in enumerate(zip(clips, labels))]

        def _run_epoch(self, dataset, pad_to_target=False):
            out = super()._run_epoch(dataset, pad_to_target)
            self.epochs.append(out)
            return out

    return SynthEvaluator


def gsc_near(p: np.ndarray, drift: float, threshold: float = 0.2, n_as: int = 527) -> np.ndarray:
    """(N,) bool: clips whose GSC decision a drift of ``drift`` could flip: a
    keyword score within it of the threshold, or the best AudioSet score and
    the keyword scores with their two largest within 2x of each other."""
    kw = p[:, n_as:]
    cand = np.sort(np.concatenate([p[:, :n_as].max(-1, keepdims=True), kw], -1), -1)
    return (np.abs(kw - threshold) <= drift).any(-1) | (cand[:, -1] - cand[:, -2] <= 2 * drift)


def cli_stdout(main, argv) -> list:
    """A CLI's main run in this process -> its stdout lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(main(argv) == 0, f"{argv} exited non-zero")
    return buf.getvalue().splitlines()


def ranked_rows(lines: list, name: str) -> list:
    """Printed rankings -> [(segment prefix, {label: probability})]: all of
    test_sample's '[idx] : pct' lines as one row, one row per --timestamps
    line of 'label p.ppp' pairs (headers as rows without labels)."""
    if name == "test_sample":
        return [("", {ln.split(":")[0].strip(): float(ln.split(":")[1]) / 100.0
                      for ln in lines})]
    rows = []
    for ln in lines:
        m = re.match(r"(\[[^]]*\]) (.*)$", ln)
        rows.append((ln, {}) if not m else (m.group(1), {
            lab.strip(): float(p) for lab, p in re.findall(r"(.+?) (\d\.\d{3})(?:  |$)",
                                                           m.group(2))}))
    return rows


def same_topk(card: list, cpu: list, name: str, tol: float) -> bool:
    """The same top-k on the card and the CPU: equal segments and labels,
    each probability within ``tol`` (the printed precision plus the drift);
    a label ranked on one side only passes if its probability exceeds the
    other side's last one by at most ``tol`` (a near-tie at the boundary)."""
    rows_a, rows_b = ranked_rows(card, name), ranked_rows(cpu, name)
    if len(rows_a) != len(rows_b):
        return False
    for (pa, ra), (pb, rb) in zip(rows_a, rows_b):
        if pa != pb or len(ra) != len(rb):
            return False
        for mine, other in ((ra, rb), (rb, ra)):
            last = min(other.values(), default=0.0)
            for lab, p in mine.items():
                if abs(p - other[lab]) > tol if lab in other else p - last > tol:
                    return False
    return True


def eval_clis(npz: Path) -> dict:
    """cli.evaluate test_sample and cli.infer --timestamps/--events (kernel
    path) on the card and on the CPU: the same top-5 (up to near-ties the
    drift can reorder) and the same segments and events."""
    from uit_mobile_tpu_torch.cli.evaluate import main as eval_main
    from uit_mobile_tpu_torch.cli.infer import main as infer_main
    from uit_mobile_tpu_torch.data import read_wav, write_wav

    three = OUT_DIR / "three_seconds.wav"
    waves = [read_wav(p)[0][0] for p in sorted((REPO / "samples").glob("*.wav"))]
    write_wav(three, np.resize(np.concatenate(waves), 3 * SR), sample_rate=SR)
    out = {}
    # printed precision (test_sample 0.01 %, timestamps 0.001) plus drift
    for name, main, argv, tol in (
            ("test_sample", eval_main,
             ["test_sample", str(npz), str(REPO / "samples" / "85b877b5_nohash_0.wav")], 2e-4),
            ("timestamps", infer_main, [str(three), "-m", str(npz), "--kernel", "-k", "5",
                                        "--timestamps"], 2e-3),
            ("events", infer_main, [str(three), "-m", str(npz), "--kernel", "--events",
                                    "--event-threshold", "0.2"], None)):
        card, cpu = (cli_stdout(main, argv + ["--device", dev]) for dev in ("cuda", "cpu"))
        same = (len(card) == len(cpu) > 0
                and (card == cpu if tol is None else same_topk(card, cpu, name, tol)))
        check(same, f"cli {name}: card {card[:8]} != CPU {cpu[:8]}")
        out[name] = {"lines": len(card), "identical": card == cpu, "first": card[:2]}
    return out


def phase_eval(npz: Path, other: Path, info) -> dict:
    """The evaluation path on the card (counts set to 0 just before each mode
    and read just after) against the same Evaluator on the CPU plain path,
    with the same weights and clips. -> {mode: launch counts}."""
    import logging

    from uit_mobile_tpu_torch.cli.train import evaluate_run
    from uit_mobile_tpu_torch.evaluate.harness import DEFAULT_SWEEP
    from uit_mobile_tpu_torch.evaluate.metrics import gsc_accuracy
    from uit_mobile_tpu_torch.ops import launches, make_framewise_fn
    from uit_mobile_tpu_torch.ops import mel as mel_ops
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.utils import get_logger, resolve_device

    log = get_logger()
    level = log.level
    log.setLevel(logging.WARNING)  # the reports go to files, not stdout
    t_phase = time.perf_counter()
    try:
        sets = eval_sets(np.random.default_rng(11))
        Ev = synth_evaluator_class(sets)
        card, cpu = Ev(str(npz), device="cuda"), Ev(str(npz), device="cpu", use_kernel=True)
        counts, rec = {}, {"phase": "eval", "model": "uit_xs", "checkpoint": npz.name,
                           "batch_size": card.batch_size, "card": info["nvidia_smi"]}

        def on_card(mode, fn):
            torch.cuda.synchronize()
            reset_launches()
            out = fn()
            torch.cuda.synchronize()
            counts[mode] = dict(launches)
            return out

        # `cli.train run`'s evaluation: GSC, then AudioSet
        run_card = on_card("run", lambda: evaluate_run(card, EVAL_RUN_CONFIG))
        run_cpu = evaluate_run(cpu, EVAL_RUN_CONFIG)
        for (pg, tg, ng), (pc, tc, nc) in zip(card.epochs, cpu.epochs):
            check(ng == nc and np.array_equal(tg, tc), "card and CPU epochs hold other clips")
        (g_card, a_card), (g_cpu, a_cpu) = [e[0] for e in card.epochs], [e[0] for e in cpu.epochs]
        drift_g, drift_a = (float(np.abs(a - b).max()) for a, b in ((g_card, g_cpu),
                                                                    (a_card, a_cpu)))
        check(g_card.shape == (64, 537) and a_card.shape == (64, 537)
              and bool(np.isfinite(g_card).all() and np.isfinite(a_card).all()),
              f"eval shapes {g_card.shape} {a_card.shape}")
        targets_g = card.epochs[0][1]
        right = [np.array([gsc_accuracy(p[i:i + 1], targets_g[i:i + 1]) for i in range(len(p))])
                 for p in (g_card, g_cpu)]
        near = gsc_near(g_cpu, drift_g)
        flipped = right[0] != right[1]
        map_card, map_cpu = run_card["audioset"]["mAP"], run_cpu["audioset"]["mAP"]
        rec["audioset"] = {"clips": 64, "seconds": 10, "max_abs_prob_drift": drift_a,
                           "mAP_card": map_card, "mAP_cpu": map_cpu,
                           "mAPKWS_card": run_card["audioset"].get("mAPKWS")}
        rec["gsc"] = {"clips": 64, "seconds": 1, "max_abs_prob_drift": drift_g,
                      "accuracy_card": run_card["gsc"]["Accuracy@0.2"],
                      "accuracy_cpu": run_cpu["gsc"]["Accuracy@0.2"],
                      "clips_within_drift_of_a_decision": int(near.sum()),
                      "decisions_flipped": int(flipped.sum())}
        check(drift_a <= 1e-3 and drift_g <= 1e-3 and abs(map_card - map_cpu) <= 1e-3,
              f"audioset/gsc on the card vs CPU plain path: {rec['audioset']} {rec['gsc']}")
        check(not (flipped & ~near).any(), f"GSC decisions flipped beyond the drift: {rec['gsc']}")

        cal_card = on_card("calibrate", lambda: card.calibrate(eval_data="gsc"))
        cal_cpu = cpu.calibrate(eval_data="gsc")
        rel = abs(cal_card["temperature"] - cal_cpu["temperature"]) / cal_cpu["temperature"]
        rec["calibrate"] = {"temperature_card": cal_card["temperature"],
                            "temperature_cpu": cal_cpu["temperature"], "rel_diff": rel,
                            "ECE_before": cal_card["ECE_before"],
                            "ECE_after": cal_card["ECE_after"]}
        check(rel <= 1e-3, f"calibrate on the card vs CPU: {rec['calibrate']}")

        st_kw = dict(psds=True, median_kernel=3)
        st_card = on_card("strong", lambda: card.strong(eval_data="strong", **st_kw))
        st_cpu = cpu.strong(eval_data="strong", **st_kw)
        # the strong forward at the Evaluator's batch: 16 clips padded to 32
        batch = np.zeros((card.batch_size, 10 * SR), np.float32)
        batch[:16] = np.stack(sets["strong"][0]) / 32768.0
        fw = [make_framewise_fn(*ev._resolved, use_kernel=True, top_db_mode="per_sample")(batch)
              for ev in (card, cpu)]
        (p_g, t_g), (p_c, t_c) = [(p.cpu().numpy()[:16], t) for p, t in fw]
        drift_s = float(np.abs(p_g - p_c).max())
        near_s = int(sum((np.abs(p_c - th) <= drift_s).sum() for th in (0.5,) + DEFAULT_SWEEP))
        scalar = [k for k, v in st_cpu.items() if not k.startswith("_")]
        differ = [k for k in scalar if st_card[k] != st_cpu[k]]
        curve_same = st_card["_event_operating_curve"] == st_cpu["_event_operating_curve"]
        rec["strong"] = {"clips": 16, "seconds": 10, "segments": int(p_g.shape[1]),
                         "max_abs_framewise_drift": drift_s, "times_bitwise": bool(
                             np.array_equal(t_g, t_c)),
                         "probs_within_drift_of_a_threshold": near_s,
                         "scores_differing": differ, "curve_equal": curve_same,
                         **{k: st_card[k] for k in ("Segment_Micro_F1", "Event_Micro_F1",
                                                    "PSDS")}}
        check(drift_s <= 1e-3 and rec["strong"]["times_bitwise"]
              and (near_s > 0 or (not differ and curve_same)),
              f"strong on the card vs CPU plain path: {rec['strong']}")

        fast = Ev(str(npz), device="cuda", fast=True)
        on_card("fast", lambda: evaluate_run(fast, EVAL_RUN_CONFIG))
        drift_f = max(float(np.abs(e[0] - ref).max()) for e, ref in zip(fast.epochs,
                                                                         (g_card, a_card)))
        pcm = Ev(str(npz), device="cuda", dtype="int16")
        on_card("int16", lambda: evaluate_run(pcm, EVAL_RUN_CONFIG))
        bitwise = all(np.array_equal(e[0], ref) for e, ref in zip(pcm.epochs, (g_card, a_card)))
        single = Ev(str(other), device="cuda")
        single.gsc(eval_data="gsc")
        ens = Ev(f"{npz},{other}", device="cuda")
        on_card("ensemble", lambda: ens.gsc(eval_data="gsc"))
        drift_e = float(np.abs(ens.epochs[0][0] - (g_card + single.epochs[0][0]) / 2).max())
        rec.update(fast_vs_exact_max_abs=drift_f, int16_bitwise=bitwise,
                   ensemble_vs_member_mean_max_abs=drift_e)
        check(drift_f <= 1e-3 and bitwise and drift_e <= 1e-6,
              f"fast {drift_f} (1e-3), int16 bitwise {bitwise}, ensemble {drift_e} (1e-6)")

        for mode, variant in (("run", "row_exact"), ("calibrate", "row_exact"),
                              ("strong", "row_exact"), ("int16", "row_exact"),
                              ("ensemble", "row_exact"), ("fast", "row_fast")):
            check(counts[mode][variant] > 0, f"eval {mode} never launched {variant}: "
                                             f"{counts[mode]}")
        rec["launches"] = counts

        # the mel frontend at the eval shapes against its plain version
        dev = resolve_device("cuda")
        fe_cfg = card._resolved[0].frontend
        as_b = torch.from_numpy(np.stack(sets["audioset"][0][:32]) / np.float32(32768)).to(dev)
        gsc_b = torch.from_numpy(np.stack(sets["gsc"][0][:32]) / np.float32(32768)).to(dev)
        st_b = torch.from_numpy(batch).to(dev)
        per_sample = dataclasses.replace(fe_cfg, top_db_mode="per_sample")
        rec["frontend"] = {
            "audioset_row_exact": frontend_gate(make_frontend_fn(fe_cfg), as_b, "exact", "bft"),
            "gsc_row_exact": frontend_gate(make_frontend_fn(fe_cfg), gsc_b, "exact", "bft"),
            "gsc_row_fast": frontend_gate(make_frontend_fn(fe_cfg, precision="fast"), gsc_b,
                                          "fast", "bft"),
            "strong_row_exact_per_sample": frontend_gate(make_frontend_fn(per_sample), st_b,
                                                         "exact", "bft")}
        rec["cli"] = eval_clis(npz)

        # timing: one batch on the card, and warm epochs
        timing = {}
        for name, x in (("audioset", as_b), ("gsc", gsc_b)):
            fwd = card._fwd_fn
            forward_ms = time_ms(lambda: fwd(x))
            enqueue = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fwd(x)
                enqueue.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            mel_ms = time_ms(lambda: mel_ops.log_mel(x, fe_cfg, precision="exact", layout="bft"))
            before = dict(launches)
            fwd(x)
            torch.cuda.synchronize()
            per_batch = {k: launches[k] - before[k] for k in launches if launches[k] != before[k]}
            t0 = time.perf_counter()
            (card.audioset(audioset_eval_data="audioset") if name == "audioset"
             else card.gsc(eval_data="gsc"))
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            timing[name] = {
                "B": int(x.shape[0]), "seconds": int(x.shape[1]) // SR, "input": "float32",
                "forward_ms": forward_ms, "enqueue_ms": statistics.median(enqueue),
                "mel_kernel_ms": mel_ms, "mel_share": mel_ms / forward_ms,
                "mel_launches_per_batch": per_batch,
                "forward_clips_per_s": x.shape[0] * 1e3 / forward_ms,
                "epoch_clips": 64, "epoch_s": epoch_s, "epoch_clips_per_s": 64 / epoch_s,
                **profile_steps(lambda: fwd(x), forward_ms)}
        rec["timing"] = timing
        rec["wall_s"] = time.perf_counter() - t_phase
        emit(rec)
        return counts
    finally:
        log.setLevel(level)



# ---------------------------------------------------------------- streaming, HTTP, bench

STREAM_RUNS = ((1024, "int16", "tfb_fast"), (16, "float32", "row_fast"))
STREAM_HOPS = 12  # feed_all hops of each run's main path
CPU_CHECKED_HOPS = (0, STREAM_HOPS - 1)  # the ring's seed hop and its last hop


def stream_windows(audio: np.ndarray, hop: int, seed_hops: int, k: int) -> np.ndarray:
    """The (S, 1 s) windows that feed_all hop k scores."""
    end = (seed_hops + k + 1) * hop
    return audio[:, end - SR:end]


def phase_stream(cfg, cpu_model, info) -> dict:
    """MultiStreamTagger on the card at uit_xs width: per run, each stream's
    ring seeded by feed() with 3 hops (nothing due yet), then STREAM_HOPS
    feed_all hops (the first re-seeds the device ring, the rest ship only
    the chunk), counts set to 0 just before the hops and read just after;
    5 more hops under torch.profiler for the card's idle share. Gates: the
    CPU plain path at fast precision within 1e-3; the host path (feed() at
    S=16, _push + _score at S=1024) bitwise; an int16 ring bitwise the
    float32 ring fed k/32768; the expected kernel launched every hop.
    -> {S: launch counts}."""
    from torch.autograd import DeviceType

    from uit_mobile_tpu_torch.frontend import normalize_pcm16
    from uit_mobile_tpu_torch.ops import launches, make_forward_fn
    from uit_mobile_tpu_torch.serve import MultiStreamTagger, StreamingConfig
    from uit_mobile_tpu_torch.utils.profiling import device_dispatch_ms, trace

    plain = make_forward_fn(cfg, cpu_model, use_kernel=True, precision="fast",
                            top_db_mode="per_sample")
    out = {}
    for S, dtype, variant in STREAM_RUNS:
        sc = StreamingConfig(hop_seconds=0.25, dtype=dtype)
        hop = int(sc.hop_seconds * SR)
        seed_hops = 3
        n_total = seed_hops + STREAM_HOPS + 5
        audio = pcm_batch(np.random.default_rng(S), S, n_total * hop)  # int16 PCM
        feed_in = audio if dtype == "int16" else normalize_pcm16(audio)

        def tagger(dt=dtype):
            return MultiStreamTagger(cfg, cpu_model, n_streams=S, device="cuda",
                                     config=dataclasses.replace(sc, dtype=dt))

        def chunk(data, k):
            lo = (seed_hops + k) * hop
            return data[:, lo:lo + hop]

        def seed(t, data):
            for s in range(S):
                t.feed(s, data[s, :seed_hops * hop])

        main_t = tagger()
        seed(main_t, feed_in)
        torch.cuda.synchronize()
        reset_launches()
        probs, hop_ms = [], []
        for k in range(STREAM_HOPS):
            t0 = time.perf_counter()
            evs = main_t.feed_all(chunk(feed_in, k))
            hop_ms.append(1e3 * (time.perf_counter() - t0))
            probs.append(np.stack([e.probs for e in evs]))
        counts = dict(launches)
        check(counts[variant] == STREAM_HOPS and sum(counts.values()) == STREAM_HOPS,
              f"stream S={S}: expected {STREAM_HOPS} {variant} launches, got {counts}")
        check(main_t._host_stale and main_t._dev_buf is not None,
              f"stream S={S}: the steady state left the device ring")
        # a hop split: the forward on the ring (CUDA events), its host
        # enqueue, and the host's events for one hop's probabilities
        forward_ms = time_ms(lambda: main_t._fwd(main_t._dev_buf))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main_t._fwd(main_t._dev_buf)
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main_t._emit(list(range(S)), probs[-1])
        emit_ms = 1e3 * (time.perf_counter() - t0)
        # the card's idle share over 5 more hops (utils/profiling.py)
        logdir = OUT_DIR / f"stream_trace_S{S}"
        shutil.rmtree(logdir, ignore_errors=True)
        with trace(str(logdir)) as prof:
            t0 = time.perf_counter()
            for k in range(STREAM_HOPS, STREAM_HOPS + 5):
                main_t.feed_all(chunk(feed_in, k))
            traced_ms = 1e3 * (time.perf_counter() - t0)
        busy = device_dispatch_ms(str(logdir), min_gap_us=200.0)
        kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        # gates: the CPU plain path, the host path, int16 == float32
        drift = max(float(np.abs(probs[k] - plain(
            stream_windows(audio, hop, seed_hops, k)).numpy()).max()) for k in CPU_CHECKED_HOPS)
        check(drift <= 1e-3, f"stream S={S}: drift {drift} from the CPU plain path > 1e-3")
        host_t = tagger()
        seed(host_t, feed_in)
        host_probs = []
        for k in range(STREAM_HOPS):
            c = chunk(feed_in, k)
            if S <= 16:  # the real host path: every stream fed alone
                evs = [e for s in range(S) for e in host_t.feed(s, c[s])]
            else:  # the host path's ring shift and full upload, all streams at once
                for s in range(S):
                    host_t._push(s, c[s])
                evs = host_t._score(list(range(S)))
            host_probs.append(np.stack([e.probs for e in sorted(evs, key=lambda e: e.stream)]))
        host_equal = all(np.array_equal(a, b) for a, b in zip(probs, host_probs))
        check(host_equal, f"stream S={S}: device-ring scores differ from the host path's "
                          f"(max {max(np.abs(a - b).max() for a, b in zip(probs, host_probs))})")
        other = "float32" if dtype == "int16" else "int16"
        twin = tagger(other)
        twin_in = normalize_pcm16(audio) if other == "float32" else audio
        seed(twin, twin_in)
        twin_probs = [np.stack([e.probs for e in twin.feed_all(chunk(twin_in, k))])
                      for k in range(STREAM_HOPS)]
        dtype_equal = all(np.array_equal(a, b) for a, b in zip(probs, twin_probs))
        check(dtype_equal, f"stream S={S}: the int16 ring differs from the float32 ring")
        steady = hop_ms[1:]  # the first hop re-seeds the ring with a full upload
        windows_s = S * len(steady) / (sum(steady) / 1e3)
        emit({"phase": "stream", "model": "uit_xs", "streams": S, "hop_seconds": 0.25,
              "dtype": dtype, "mel_variant": variant, "launches": counts,
              "launches_per_hop": sum(counts.values()) / STREAM_HOPS,
              "windows_per_s": windows_s, "realtime_streams": windows_s * sc.hop_seconds,
              "feed_all_p50_ms": float(np.percentile(hop_ms, 50)),
              "feed_all_p99_ms": float(np.percentile(hop_ms, 99)),
              "seed_hop_ms": hop_ms[0], "forward_ms": forward_ms,
              "forward_enqueue_ms": enqueue_ms, "emit_ms": emit_ms,
              "max_abs_drift_vs_cpu": drift, "cpu_checked_hops": list(CPU_CHECKED_HOPS),
              "host_path": "feed()" if S <= 16 else "_push + _score",
              "host_path_bitwise": host_equal, "int16_vs_float32_bitwise": dtype_equal,
              "profiled_hops": 5, "profiled_ms": traced_ms,
              "device_busy_ms_per_hop": sum(busy) / 5,
              "device_idle_share": 1.0 - sum(busy) / traced_ms,
              "device_kernels_per_hop": kernels / 5, "card": info["nvidia_smi"]})
        out[S] = counts
    return out


def http_request(url: str, body=None, ctype="application/octet-stream"):
    """-> (status, body bytes) of a GET (body None) or a POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def same_top(card: list, want: np.ndarray, tol: float) -> bool:
    """The card's top-k indices against the CPU's probabilities: each
    position the CPU's index or a tie with it within ``tol``."""
    ref = np.argsort(want)[::-1][:len(card)]
    return all(i == j or abs(want[i] - want[j]) <= tol for i, j in zip(card, ref))


def phase_http(cfg, cpu_model, info) -> dict:
    """make_http_server on 127.0.0.1:0 in a thread over a card TaggingService
    (int16, the default buckets), StreamSessions (8 slots) and the /events
    scorer: 64 concurrent POST /tag (WAV, pcm16, f32; 1 s and 3 s), one
    /events on a 10 s clip of the samples and silence, one stream session
    (open, ragged feeds, close), /healthz, /metrics; counts set to 0 just
    before the /tag burst and read after the session closed. Then /reload
    with new weights and a calibrated service. -> launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.cli.common import load_label_map
    from uit_mobile_tpu_torch.data import read_wav, write_wav
    from uit_mobile_tpu_torch.evaluate import apply_temperature, extract_events
    from uit_mobile_tpu_torch.frontend import normalize_pcm16
    from uit_mobile_tpu_torch.ops import launches, make_forward_fn
    from uit_mobile_tpu_torch.serve import (MultiStreamTagger, ServiceConfig, StreamingConfig,
                                            StreamSessions, TaggingService, make_framewise_fn,
                                            make_http_server)

    labels = load_label_map()
    new_model = models.build(cfg, torch.Generator().manual_seed(4321), device="cpu")
    svc = TaggingService(cfg, cpu_model, ServiceConfig(dtype="int16"), device="cuda")
    sessions = StreamSessions(cfg, cpu_model, max_sessions=8, device="cuda")
    framewise = make_framewise_fn(cfg, cpu_model, max_seconds=10, device="cuda")

    def reload_fn():
        info_ = {"weights_version": svc.reload(new_model)}
        info_["_framewise_fn"] = make_framewise_fn(cfg, new_model, max_seconds=10,
                                                   device="cuda")
        info_["stream_sessions"] = ("reloaded" if sessions.reload(cfg, new_model)
                                    else "deferred")
        return info_

    server = make_http_server(svc, labels=labels, port=0, model_name="uit_xs",
                              framewise_fn=framewise, stream_sessions=sessions,
                              reload_fn=reload_fn)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(5)
    clips = [pcm_batch(rng, 1, (1 if i % 4 else 3) * SR)[0] for i in range(64)]
    bodies = []
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for i, pcm in enumerate(clips):
        fmt = ("wav", "pcm16", "f32")[i % 3]
        if fmt == "wav":
            path = OUT_DIR / f"http_{i}.wav"
            write_wav(path, normalize_pcm16(pcm))
            bodies.append(("/tag?full=1", path.read_bytes(), "audio/wav"))
        elif fmt == "pcm16":
            bodies.append(("/tag?format=pcm16&full=1", pcm.astype("<i2").tobytes(), None))
        else:
            bodies.append(("/tag?format=f32&full=1",
                           normalize_pcm16(pcm).astype("<f4").tobytes(), None))
    waves = [read_wav(p)[0][0] for p in sorted((REPO / "samples").glob("*.wav"))]
    ten = np.zeros(10 * SR, np.float32)
    pos = 0
    for w in waves:  # the samples with a second of silence after each, to 10 s
        n = min(len(w), len(ten) - pos)
        ten[pos:pos + n] = w[:n]
        pos += n + SR
        if pos >= len(ten):
            break
    ragged = [3000, 9000, 500, 12000, 7000, 1, 8499]
    session_audio = pcm_batch(np.random.default_rng(6), 1, sum(ragged))[0]

    def tag(item):
        path, body, ctype = item
        t0 = time.perf_counter()
        code, raw = http_request(base + path, body, ctype or "application/octet-stream")
        return code, json.loads(raw), 1e3 * (time.perf_counter() - t0)

    pool = ThreadPoolExecutor(64)
    try:
        # the client's 64 threads started and one request served before
        # the timed burst (a cold client's first burst times its own start)
        ready = threading.Barrier(65)
        for _ in range(64):
            pool.submit(ready.wait, 60)
        ready.wait(60)
        check(tag(bodies[1])[0] == 200, "warm-up /tag failed")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        results = list(pool.map(tag, bodies))
        burst_s = time.perf_counter() - t0
        code, raw = http_request(base + "/events?format=f32&threshold=0.5",
                                 ten.astype("<f4").tobytes())
        check(code == 200, f"/events returned {code}: {raw[:200]}")
        events = json.loads(raw)
        _, raw = http_request(base + "/stream/open?on=0.5&off=0.3", b"")
        sid = json.loads(raw)["id"]
        slot = sessions._sessions[sid]["slot"]
        windows, pos = [], 0
        for n in ragged:
            code, raw = http_request(f"{base}/stream/{sid}/feed?format=pcm16&k=5",
                                     session_audio[pos:pos + n].astype("<i2").tobytes())
            check(code == 200, f"/stream feed returned {code}")
            windows += json.loads(raw)["windows"]
            pos += n
        code, _ = http_request(f"{base}/stream/{sid}/close", b"")
        check(code == 200, f"/stream close returned {code}")
        counts = dict(launches)
        _, raw = http_request(base + "/healthz")
        health = json.loads(raw)
        code, metrics = http_request(base + "/metrics")
        check(code == 200 and b"uit_requests_total" in metrics, "/metrics")
        # /reload with new weights: /tag then scores with them
        code, raw = http_request(base + "/reload", b"")
        reloaded = json.loads(raw)
        check(code == 200 and reloaded["weights_version"] == 2
              and reloaded["stream_sessions"] == "reloaded", f"/reload: {reloaded}")
        _, raw = http_request(base + "/tag?format=pcm16&full=1", clips[1].astype("<i2").tobytes())
        after = np.asarray(json.loads(raw)["probs"])
    finally:
        pool.shutdown()
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=60)

    # gates against the CPU plain path (fast, per-sample clamp, bucket-padded)
    plain = make_forward_fn(cfg, cpu_model, use_kernel=True, precision="fast",
                            top_db_mode="per_sample")
    check(all(c == 200 for c, _, _ in results), "a /tag request failed")
    drift, top_ok = 0.0, True
    for pcm, (_, out, _) in zip(clips, results):
        want = plain(pcm[None]).numpy()[0]
        got = np.asarray(out["probs"])
        drift = max(drift, float(np.abs(got - want).max()))
        top_ok &= same_top([t["index"] for t in out["top"]], want, 1e-3)
    check(drift <= 1e-3, f"/tag drift {drift} from the CPU plain path > 1e-3")
    check(top_ok, "/tag top-k differs from the CPU plain path beyond ties")
    new_plain = make_forward_fn(cfg, new_model, use_kernel=True, precision="fast",
                                top_db_mode="per_sample")
    reload_drift = float(np.abs(after - new_plain(clips[1][None]).numpy()[0]).max())
    check(reload_drift <= 1e-3, f"/tag after /reload: drift {reload_drift} from the new weights")
    # /events against the CPU scorer (exact, plain), class by class where no
    # segment lies within 1e-3 of the threshold
    cpu_fw = make_framewise_fn(cfg, cpu_model, max_seconds=10, use_kernel=True, device="cpu")
    cpu_probs, times = cpu_fw(ten)
    near = np.abs(cpu_probs - 0.5) <= 1e-3
    cpu_events = [e for e in extract_events(times, cpu_probs, threshold=0.5) if e[1] < 10.0]
    clear = {c for c in range(cpu_probs.shape[1]) if not near[:, c].any()}
    card_ev = sorted((e["index"], e["onset"], e["offset"]) for e in events["events"]
                     if e["index"] in clear)
    cpu_ev = sorted((int(c), float(a), float(min(b, 10.0))) for c, a, b in cpu_events
                    if c in clear)
    check(card_ev == cpu_ev, f"/events differ from the CPU path on clear classes: "
                             f"{card_ev[:5]} vs {cpu_ev[:5]}")
    # the session's windows against a CPU tagger fed the same audio in the same slot
    ref = MultiStreamTagger(cfg, cpu_model, n_streams=8, device="cpu",
                            config=StreamingConfig(use_kernel=True))
    ref_windows, pos = [], 0
    for n in ragged:
        ref_windows += ref.feed(slot, session_audio[pos:pos + n])
        pos += n
    check(len(windows) == len(ref_windows) > 0, "stream session window count")
    sess_drift = max(max(abs(t["prob"] - float(r.probs[t["index"]])) for t in w["top"])
                     for w, r in zip(windows, ref_windows))
    check(sess_drift <= 1e-3, f"/stream drift {sess_drift} from the CPU tagger > 1e-3")
    check(health["status"] == "ok" and health["platform"] == "gpu"
          and health["device"] == torch.cuda.get_device_name(0)
          and health["requests"] >= 1 + 64 + 1 + len(ragged) + 2, f"/healthz: {health}")
    check(counts["tfb_fast"] > 0 and counts["row_fast"] > 0 and counts["row_exact"] > 0,
          f"the HTTP path did not launch tfb_fast, row_fast and row_exact: {counts}")
    # a calibrated service: apply_temperature of the uncalibrated one's output
    temp = np.linspace(0.6, 2.4, cfg.outputdim)
    small = ServiceConfig(dtype="int16", batch_size=64, max_seconds=1)
    one_s = [c for c in clips if len(c) == SR][:16]
    with TaggingService(cfg, cpu_model, small, device="cuda") as raw_svc, \
            TaggingService(cfg, cpu_model, small, device="cuda", calibration=temp) as cal_svc:
        raw_p = np.stack(raw_svc.infer_many(one_s))
        cal_p = np.stack(cal_svc.infer_many(one_s))
    cal_diff = float(np.abs(cal_p - apply_temperature(raw_p, temp)).max())
    check(cal_diff <= 1e-6, f"calibrated service vs apply_temperature: {cal_diff} > 1e-6")
    lat = [ms for _, _, ms in results]
    emit({"phase": "http", "model": "uit_xs", "tag_requests": len(results),
          "tag_formats": ["wav", "pcm16", "f32"], "tag_seconds": [1, 3],
          "requests_per_s": len(results) / burst_s,
          "tag_p50_ms": float(np.percentile(lat, 50)), "tag_p99_ms": float(np.percentile(lat, 99)),
          "server_latency_ms": health["latency_ms"], "launches": counts,
          "max_abs_drift_vs_cpu": drift, "topk_equal_up_to_ties": top_ok,
          "events": len(events["events"]), "events_classes_compared": len(clear),
          "events_classes_near_threshold": cpu_probs.shape[1] - len(clear),
          "stream_windows": len(windows), "stream_max_abs_drift_vs_cpu": sess_drift,
          "reload_drift_vs_new_weights": reload_drift,
          "calibrated_vs_apply_temperature": cal_diff, "card": info["nvidia_smi"]})
    return counts


# the JAX CLI's printed name=value fields per mode (uit_mobile_tpu/cli/bench.py:137-141,
# :364-365) and the numbers its --stream line states (:179-185), as the port names them
BENCH_FIELDS = {
    "serve": ("p50", "p95", "p99", "requests", "concurrency", "req_per_s"),
    "stream": ("streams", "hop", "windows_per_s", "realtime_streams", "ms_per_hop"),
    "frontend": ("batch", "clip", "device", "pipelined", "blocking_p50"),
}


def phase_bench(info) -> None:
    """cli.bench.main in this process, three modes at small counts: each
    prints one JSON record with the JAX CLI's field names, finite numbers,
    and the card."""
    import contextlib
    import io

    from uit_mobile_tpu_torch.cli.bench import main as bench_main

    for mode, argv in (("serve", ["--serve", "--serve-requests", "256"]),
                       ("stream", ["--stream", "--streams", "1024"]),
                       ("frontend", ["--frontend-only"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            check(bench_main(argv) == 0, f"cli.bench {argv} exited non-zero")
        rec = json.loads(buf.getvalue().splitlines()[-1])
        missing = [k for k in BENCH_FIELDS[mode] if k not in rec]
        check(not missing and rec["mode"] == mode, f"cli.bench {mode}: missing {missing}")
        numbers = [rec[k] for k in BENCH_FIELDS[mode] if k != "device"]
        check(all(isinstance(x, (int, float)) and np.isfinite(x) for x in numbers),
              f"cli.bench {mode}: non-finite {numbers}")
        check(rec["card"] == info["nvidia_smi"] and rec["device"] == "gpu",
              f"cli.bench {mode}: card {rec['card']}")
        emit({"phase": "bench", "argv": argv, "wall_s": time.perf_counter() - t0, **rec})


# ------------------------------------------------------------- parallelism

# the card the parallel phase's ranks and replicas share (the smoke run has
# one card: NCCL takes one rank a card, so two ranks share it over gloo)
CARD = "cuda:0"
PARALLEL_DEADLINE_S = 300  # a rank's rendezvous timeout, and the deadline of its join
# one step of each configuration as two ranks of one global batch: B, the
# student's mel layout, frontend precision, int16 input, the kernel each
# rank's student (B/2 rows) and teacher (B/4) launch
DP_STEPS = {"recipe": (32, "bft", "exact", False, "row_exact"),
            "frontier": (1024, "tfb", "fast", True, "tfb_fast")}
DP_LR, DP_EPS = 1e-3, 1e-8  # the steps' AdamW (constant lr, optax's eps)


def relu_signs(record: list | None = None, impose: list | None = None):
    """Patch the encoder MLP's ReLU (models/common.py ACTIVATIONS) to record
    each call's signs into ``record``, or to impose another run's signs
    popped from ``impose`` (the gradient then follows those signs) -> the
    function that restores it."""
    from uit_mobile_tpu_torch.models import common

    orig = common.ACTIVATIONS["relu"]

    def relu(z):
        if impose is not None:
            return z * impose.pop(0).to(z.device, z.dtype)
        record.append((z > 0).detach().cpu())
        return orig(z)

    common.ACTIVATIONS["relu"] = relu
    return lambda: common.ACTIVATIONS.__setitem__("relu", orig)


def dp_parts(name: str) -> dict:
    """The seeded weights and global batch of DP_STEPS[name] (numpy), [all
    AudioSet filler rows, all keyword rows], with the recipe's augments."""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ckpt import module_to_numpy

    B, layout, precision, int16, _ = DP_STEPS[name]
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102, mel_layout=layout)
    t_cfg = models.get_model_config("MobileNetV2", outputdim=527)
    rng = np.random.default_rng(11)
    n_as = B // 2
    clips_as, _ = synth_split(rng, n_as, False)
    clips_kws, labels = synth_split(rng, B - n_as, True)
    pcm = np.stack(clips_as + clips_kws)
    target = np.zeros((B, 537), np.float32)
    target[:n_as, 0] = 1.0
    target[np.arange(n_as, B), labels] = 1.0
    c = RECIPE if name == "recipe" else FRONTIER
    return {"cfg": cfg, "t_cfg": t_cfg, "precision": precision, "layout": layout,
            "student": module_to_numpy(models.build(cfg, torch.Generator().manual_seed(7), "cpu")),
            "teacher": module_to_numpy(models.build(t_cfg, torch.Generator().manual_seed(8),
                                                    "cpu")),
            "wav": pcm if int16 else pcm.astype(np.float32) / 32768.0, "target": target,
            "wavtransforms": c["wavtransforms"], "spectransforms": c["spectransforms"]}


def dp_step(parts: dict, rows=None, sl: slice = slice(None), psl: bool = True,
            fsdp: bool = False, record: list | None = None, impose: list | None = None,
            timed: bool = False) -> dict:
    """One step of a DP_STEPS configuration on CARD: the whole batch (rows
    None) or this rank's share of it ([its audioset rows, its kws rows]);
    the PSL step, or without ``psl`` the weak step, on the FSDP-sharded
    student with ``fsdp``. ``record``/``impose``: relu_signs. -> loss,
    pre-clip norm, updated params and gradients (host), mel launches, and
    with ``timed`` the step's CUDA-event median over more steps."""
    from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
    from uit_mobile_tpu_torch.ckpt import module_from_numpy
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.parallel import process_mesh
    from uit_mobile_tpu_torch.parallel.fsdp import fsdp_shard_params, make_fsdp_train_step
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    dev = torch.device(CARD)
    cfg, t_cfg = parts["cfg"], parts["t_cfg"]
    layout, precision = parts["layout"], parts["precision"]
    B = len(parts["wav"])
    h, a, b = B // 2, (sl.start or 0) // 2, (sl.stop or B) // 2
    batch = {k: torch.from_numpy(np.concatenate([parts[k][a:b], parts[k][h + a:h + b]])).to(dev)
             for k in ("wav", "target")}
    model = module_from_numpy(cfg, *parts["student"], device=dev)
    kw = dict(rows=rows, wav_augment=parse_wavtransforms(parts["wavtransforms"]),
              spec_augment=parse_spectransforms(parts["spectransforms"], layout=layout),
              frontend_fn=make_frontend_fn(cfg.frontend, precision=precision, layout=layout))
    if fsdp:
        root, _ = fsdp_shard_params(process_mesh(dev), model)
        opt = build_optimizer("AdamW", DP_LR, weight_decay=5e-8).init(root.model)
        step = make_fsdp_train_step(cfg, root, opt, **kw)
    elif not psl:
        opt = build_optimizer("AdamW", DP_LR, weight_decay=5e-8).init(model)
        step = make_train_step(cfg, model, opt, **kw)
    else:
        teacher = module_from_numpy(t_cfg, *parts["teacher"], device=dev).requires_grad_(False)
        opt = build_optimizer("AdamW", DP_LR, weight_decay=5e-8).init(model)
        step = make_train_step(
            cfg, model, opt, psl_cfg=t_cfg, psl_model=teacher, psl_split=b - a,
            psl_frontend_fn=make_frontend_fn(t_cfg.frontend, precision=precision,
                                             layout="tfb_to_bft"), **kw)
    grads = step_grads(opt)
    restore = relu_signs(record, impose) if (record is not None or impose is not None) else None
    try:
        torch.cuda.synchronize()
        reset_launches()
        m = step(batch, torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        counts = dict(launches)
    finally:
        if restore is not None:
            restore()

    def host(t):  # a copy: the timed steps below move the parameters on
        if hasattr(t, "to_local"):  # an FSDP shard: gather it with c10d (DTensor's
            import torch.distributed as dist  # full_tensor crashed on gloo + CUDA)

            local = t.to_local().detach().contiguous()
            parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, local)
            t = torch.cat(parts, dim=t.placements[0].dim)
        return t.detach().cpu().clone()

    out = {"loss": m["total_loss"].item(), "grad_norm": m["grad_norm"].item(),
           "params": {n: host(p) for n, p in model.named_parameters()},
           "grads": {n: host(g) for n, g in grads.items()}, "launches": counts}
    if timed:  # more steps of the same batch, after the recorded one
        out["step_ms"] = time_ms(lambda: step(batch, torch.Generator(device=dev).manual_seed(3)),
                                 warmup=2, iters=10)
    return out


def dp_agreement(got: dict, want: dict) -> dict:
    """The N-rank step against the single-process step: the gates of
    tests/test_torch_parallel.py (loss 1e-5 relative, pre-clip norm 1e-4
    relative, every gradient within 1e-5 of its tensor's largest, every
    parameter within 5e-5 plus what that gradient gate can move Adam's
    first step, lr * eps * dg / (|g| + eps)^2)."""
    rel = {k: ((got["grads"][k] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
           for k, g in want["grads"].items()}
    over = 0
    worst_p = 0.0
    for k, p in want["params"].items():
        g = want["grads"][k]
        dg = 1e-5 * g.abs().max().clamp(min=1e-30)
        bound = 5e-5 + DP_LR * DP_EPS * dg / ((g.abs() - dg).clamp(min=0) + DP_EPS) ** 2
        d = (got["params"][k] - p).abs()
        over += int((d > bound).sum())
        worst_p = max(worst_p, d.max().item())
    worst_g = max(rel, key=rel.get)
    rec = {"loss": got["loss"], "loss_single": want["loss"],
           "loss_rel_err": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "grad_norm_rel_err": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
           "max_grad_rel_diff": rel[worst_g], "worst_grad_tensor": worst_g,
           "params_max_abs_diff": worst_p, "params_over_bound": over}
    rec["agrees"] = (rec["loss_rel_err"] <= 1e-5 and rec["grad_norm_rel_err"] <= 1e-4
                     and rec["max_grad_rel_diff"] <= 1e-5 and over == 0)
    return rec


def global_signs(rank_signs: list, blocks_of_rank) -> list:
    """Each rank's recorded ReLU signs -> the global batch's, call by call
    (a call's rows are the rank's rows of the global batch)."""
    from uit_mobile_tpu_torch.parallel.rows import Rows

    world = len(rank_signs)
    out = []
    for i in range(len(rank_signs[0])):
        local = [s[i] for s in rank_signs]
        full = torch.empty((local[0].shape[0] * world,) + tuple(local[0].shape[1:]),
                           dtype=torch.bool)
        for r, s in enumerate(local):
            full[Rows(blocks_of_rank, "cpu", rank=r, world=world).index] = s
        out.append(full)
    return out


def dp_rank(argv) -> int:
    """One rank of the shared-card check (``chip_smoke.py --dp-rank R W PORT
    DIR BACKEND DEVICE``; DEVICE is the parent's CARD). gloo: the check that gloo carries FSDP2's
    collectives for CUDA tensors, the recipe and frontier PSL steps on this
    rank's share, then the FSDP step if the check passed; nccl (one rank):
    the FSDP step alone. ReLU signs recorded; results to DIR."""
    import torch.distributed as dist

    from uit_mobile_tpu_torch.parallel import multihost
    from uit_mobile_tpu_torch.parallel.rows import Rows
    from uit_mobile_tpu_torch.utils import resolve_device

    global CARD
    rank, world, port, workdir, backend, CARD = (int(argv[0]), int(argv[1]), argv[2],
                                                 Path(argv[3]), argv[4], argv[5])
    dev = resolve_device(CARD)  # TF32 off, as in the single-process steps
    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device=dev,
                         backend=backend, timeout=PARALLEL_DEADLINE_S)
    res = {"gloo_cuda_fsdp_collectives": False}
    if backend == "gloo":
        gathered = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(gathered, torch.arange(4.0, device=dev) + 4 * rank)
        scattered = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(scattered, torch.arange(2.0 * world, device=dev))
        res["gloo_cuda_fsdp_collectives"] = bool(
            gathered.tolist() == list(range(4 * world))
            and scattered.tolist() == [world * 2.0 * rank, world * (2.0 * rank + 1)])
        for name in DP_STEPS:
            parts = dp_parts(name)
            B = len(parts["wav"])
            signs: list = []
            res[name] = dp_step(parts, Rows([B // 2 // world] * 2, dev),
                                multihost.host_local_batch_slice(B), record=signs,
                                timed=name == "recipe")
            res[name]["signs"] = signs
    if backend == "nccl" or res["gloo_cuda_fsdp_collectives"]:
        parts = dp_parts("recipe")
        B = len(parts["wav"])
        signs = []
        res["fsdp"] = dp_step(parts, Rows([B // 2 // world] * 2, dev),
                              multihost.host_local_batch_slice(B), psl=False, fsdp=True,
                              record=signs)
        res["fsdp"]["signs"] = signs
    torch.save(res, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def npz_arrays(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def trainer_log(path: Path) -> dict:
    """A Trainer's train.log -> the step ms of each epoch (1000 / it/s), the
    mel kernel launches the process logged at its end, and the text."""
    text = path.read_text()
    its = [float(x) for x in re.findall(r"Epoch \d+\s+loss \S+ \(([\d.]+) it/s\)", text)]
    launched = re.findall(r"mel kernel launches: (\{.*\})", text)
    check(bool(its) and bool(launched), f"{path}: no epoch or launch line")
    return {"epoch_step_ms": [1000.0 / x for x in its], "launches": json.loads(launched[-1]),
            "log": text}


def run_with_deadline(argv: list, deadline: float) -> tuple:
    """Run ``argv`` in its own process group; at the deadline kill the group
    (a launcher's ranks too). -> (exit code, output)."""
    import os
    import signal

    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=REPO, start_new_session=True)
    try:
        out = proc.communicate(timeout=deadline)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0] + f"\n[killed at the {deadline} s deadline]"
    finally:
        try:  # nothing of the group outlives the call
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode, out


def spawn_ranks(argvs: list, deadline: float) -> list:
    """Start every rank; join each within ``deadline`` s of the start, and
    kill them all on a failure or at the deadline. -> their outputs."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO) for a in argvs]
    t_end, outs = time.monotonic() + deadline, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, t_end - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def dp_spawn(work: Path, world: int, backend: str) -> list:
    """Run dp_rank on ``world`` processes sharing CARD -> their results."""
    port = str(free_port())
    spawn_ranks([[sys.executable, "-X", "faulthandler", str(REPO / "chip_smoke.py"), "--dp-rank",
                  str(r), str(world), port, str(work), backend, CARD] for r in range(world)],
                PARALLEL_DEADLINE_S)
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


def dp_versus_single(name: str, ranks: list, parts: dict, psl: bool, info) -> dict:
    """The ranks' step ``name`` against the single-process global step on
    CARD, without and then given the ranks' ReLU signs (a sign that lies
    within rounding of 0 may flip between the two summation orders and
    move a whole term of fc1's gradient): the ranks end bitwise alike, the
    loss within 1e-5 either way, the flips under 1e-5 of the ReLU inputs,
    and dp_agreement given the ranks' signs."""
    B = len(parts["wav"])
    signs: list = []
    free = dp_step(parts, psl=psl, record=signs, timed=name == "recipe")
    world = len(ranks)
    dp_signs = global_signs([r[name]["signs"] for r in ranks], [B // 2 // world] * 2)
    flips = int(sum((a != b).sum() for a, b in zip(dp_signs, signs)))
    given = dp_step(parts, psl=psl, impose=list(dp_signs))
    got = ranks[0][name]
    same_ranks = all(torch.equal(got["params"][k], r[name]["params"][k])
                     for r in ranks[1:] for k in got["params"])
    rec = {"phase": "parallel", "path": f"{world}_ranks_{name}", "B": B,
           "rows_a_rank": B // world, "mel_launches_by_rank": [r[name]["launches"] for r in ranks],
           "relu_inputs": int(sum(s.numel() for s in signs)), "relu_flips": flips,
           "ranks_params_bitwise": same_ranks,
           "vs_single_given_rank_signs": dp_agreement(got, given),
           "vs_single": dp_agreement(got, free), "card": info["nvidia_smi"]}
    if "step_ms" in free:
        rec["single_step_ms"] = free["step_ms"]
    check(same_ranks and rec["vs_single_given_rank_signs"]["agrees"]
          and rec["vs_single"]["loss_rel_err"] <= 1e-5 and flips <= 1e-5 * rec["relu_inputs"],
          f"{world} ranks vs one process, {name}: {rec}")
    return rec


def phase_parallel(info) -> dict:
    """Data parallelism on the one card (not a scaling measurement):
    (a) the recipe for three short epochs through ``cli.launch 1`` (the
        real cli.train as one NCCL rank) against ``cli.train`` in one
        process, on the same files and seed: last.npz bitwise, or the
        largest gap printed; launches and step times from their logs;
    (b) two ranks sharing the card over gloo: one recipe step (B=32, 16 a
        rank, row_exact in student and teacher) and one frontier step
        (B=1024, 512 a rank, tfb_fast in both) against the single-process
        global step on the card (dp_agreement), given the ranks' ReLU signs
        and without them (the flips counted);
    (c) the FSDP step (the recipe's student, no teacher): two ranks over
        gloo when the ranks' check shows gloo carrying FSDP2's collectives
        for CUDA tensors, else one rank on NCCL; held as (b);
    (d) Evaluator and TaggingService data parallel over a mesh of two CARD
        replicas, the kernel on every shard: fast (per-sample clamp) against
        the non-DP per-sample run, exact and the service's 'torch' clamp
        (the batch-global max reduced over the shards) against their non-DP
        runs, within 1e-3;
    (e) the one-rank step against the single-process step, and the shared-
        card two-rank step (time-sliced on one card, not a scaling number).
    -> {path: mel launch counts}."""
    import tempfile

    counts: dict = {}
    work = Path(tempfile.mkdtemp(prefix="uit_parallel_"))

    # (a) one rank on NCCL through cli.launch, against one process through
    # cli.train: the recipe on a synthetic world of files (an .npz store: the
    # card's machine has no h5py)
    from uit_mobile_tpu_torch.data.synthworld import build_world

    config = dict(RECIPE, epochs=3, epoch_length=8, valid_every=1, num_workers=1,
                  **build_world(work / "world", seed=42, n_train=64, n_eval=32, store="npz"))
    cfg_path = work / "recipe.yaml"
    cfg_path.write_text(json.dumps(config))  # JSON is YAML
    runs = {}
    for name, argv in (("single", ["uit_mobile_tpu_torch.cli.train", "train"]),
                       ("launched", ["uit_mobile_tpu_torch.cli.launch", "1", "train"])):
        t0 = time.perf_counter()
        code, out = run_with_deadline(
            [sys.executable, "-m", *argv, str(cfg_path), "--device", "cuda",
             "--outputdir", str(work / name)], PARALLEL_DEADLINE_S)
        check(code == 0, f"{' '.join(argv)} exited {code}:\n{out[-4000:]}")
        runs[name] = dict(trainer_log(work / name / "train.log"),
                          wall_s=time.perf_counter() - t0)
    single, launched = runs["single"], runs["launched"]
    check("multi-host: process 0/1" in launched["log"]
          and "data-parallel over 1 devices" in launched["log"]
          and "multi-host" not in single["log"],
          "cli.launch 1 did not run one rank of a process group with its mesh")
    want, got = (npz_arrays(work / d / "last.npz") for d in ("single", "launched"))
    gaps = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in want}
    bitwise = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    rec = {"phase": "parallel", "path": "launch_1_nccl", "bitwise_last_npz": bitwise,
           "largest_gap": max(gaps.values()), "largest_gap_array": max(gaps, key=gaps.get),
           "single_wall_s": single["wall_s"], "launch_wall_s": launched["wall_s"],
           "single_launches": single["launches"], "rank0_launches": launched["launches"],
           "single_epoch_step_ms": single["epoch_step_ms"],
           "world1_epoch_step_ms": launched["epoch_step_ms"],
           "step_ms_from": "the Trainer's log: 1000 / it/s of each epoch (host clock, one "
                           "sync an epoch, the loader included)",
           "card": info["nvidia_smi"]}
    if not bitwise:  # is one process even bitwise with itself?
        code, out = run_with_deadline(
            [sys.executable, "-m", "uit_mobile_tpu_torch.cli.train", "train", str(cfg_path),
             "--device", "cuda", "--outputdir", str(work / "again")], PARALLEL_DEADLINE_S)
        check(code == 0, f"cli.train again exited {code}:\n{out[-4000:]}")
        rerun = npz_arrays(work / "again" / "last.npz")
        rec["single_rerun_bitwise"] = all(np.array_equal(rerun[k], want[k]) for k in want)
    emit(rec)
    check(rec["largest_gap"] <= 1e-3 and launched["launches"]["row_exact"] > 0
          and launched["launches"] == single["launches"],
          f"cli.launch 1 against one process: {rec}")
    counts["cli_train_single"] = single["launches"]
    counts["launch_1_nccl_rank0"] = launched["launches"]

    # (b, c) two ranks sharing the card over gloo
    t0 = time.perf_counter()
    ranks = dp_spawn(work, 2, "gloo")
    spawn_wall = time.perf_counter() - t0
    for name, (B, _, _, _, variant) in DP_STEPS.items():
        rec = dp_versus_single(name, ranks, dp_parts(name), True, info)
        rec["spawn_wall_s"] = spawn_wall
        if name == "recipe":
            rec.update(shared_card_2_rank_step_ms=[r[name]["step_ms"] for r in ranks],
                       note="two ranks time-slice one card over gloo: not a scaling number")
        emit(rec)
        check(all(r[name]["launches"][variant] == 2 for r in ranks),
              f"{name}: a rank did not launch {variant} for its student and its teacher: "
              f"{rec['mel_launches_by_rank']}")
        for r in range(2):
            counts[f"gloo_2_ranks_{name}_rank{r}"] = ranks[r][name]["launches"]
    gloo_fsdp = all(r["gloo_cuda_fsdp_collectives"] for r in ranks)
    emit({"phase": "parallel", "path": "fsdp_route",
          "gloo_carries_fsdp_collectives_on_cuda": gloo_fsdp,
          "fsdp_world": 2 if gloo_fsdp else 1, "backend": "gloo" if gloo_fsdp else "nccl"})
    fsdp_ranks = ranks if gloo_fsdp else dp_spawn(work, 1, "nccl")
    rec = dp_versus_single("fsdp", fsdp_ranks, dp_parts("recipe"), False, info)
    emit(rec)
    for r, rr in enumerate(fsdp_ranks):
        counts[f"fsdp_rank{r}"] = rr["fsdp"]["launches"]

    # (d) in-process data parallelism over two replicas on the card
    counts.update(dp_in_process(work, info))
    shutil.rmtree(work, ignore_errors=True)
    return counts


def dp_in_process(work: Path, info) -> dict:
    """(d): the Evaluator and the TaggingService data parallel over a mesh
    of two CARD replicas against their non-DP runs on the same clips and
    weights, within 1e-3 (the JAX budget), the kernel on every shard: fast
    with the per-sample clamp (against make_forward_fn's per-sample fast
    forward), exact with the batch-global clamp reduced over the shards
    (against the non-DP exact Evaluator), and the service with either
    clamp against its non-DP run. Launch counts set to 0 before each DP run
    and read after."""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ops import launches, make_forward_fn
    from uit_mobile_tpu_torch.parallel import make_mesh
    from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

    from uit_mobile_tpu_torch.ckpt import save_checkpoint

    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
    model = models.build(cfg, torch.Generator().manual_seed(1234), device=CARD)
    npz = work / "uit_xs_seed1234.npz"
    save_checkpoint(npz, model, cfg)
    sets = eval_sets(np.random.default_rng(12))
    Ev = synth_evaluator_class(sets)
    mesh = make_mesh(devices=[CARD, CARD])
    counts, rec = {}, {"phase": "parallel", "path": "in_process_mesh",
                       "mesh": [str(d) for d in mesh.devices]}
    clips = np.stack([c.astype(np.float32) / 32768.0 for c in sets["gsc"][0]])

    def dp_eval(**kw):
        ev = Ev(str(npz), device=CARD, data_parallel=mesh, **kw)
        torch.cuda.synchronize()
        reset_launches()
        ev.gsc(eval_data="gsc")
        torch.cuda.synchronize()
        return ev, ev.epochs[-1][0], dict(launches)

    ev, got, counts["dp_eval_fast"] = dp_eval(fast=True)
    fwd = make_forward_fn(cfg, model, use_kernel=True, precision="fast", btf=True,
                          top_db_mode="per_sample")
    want = np.concatenate([fwd(clips[i:i + ev.batch_size]).cpu().numpy()
                           for i in range(0, len(clips), ev.batch_size)])
    rec["eval_fast"] = {"route": [ev._fwd_fn.uses_kernel, ev._fwd_fn.top_db_mode],
                        "max_abs_diff_vs_non_dp_per_sample": float(np.abs(got - want).max()),
                        "launches": counts["dp_eval_fast"]}
    ev, got, counts["dp_eval_exact"] = dp_eval()
    plain = Ev(str(npz), device=CARD)
    plain.gsc(eval_data="gsc")
    rec["eval_exact"] = {"route": [ev._fwd_fn.uses_kernel, ev._fwd_fn.top_db_mode],
                         "max_abs_diff_vs_non_dp_exact":
                             float(np.abs(got - plain.epochs[-1][0]).max()),
                         "launches": counts["dp_eval_exact"]}
    pcm = list(np.stack(sets["gsc"][0]))
    for mode in ("per_sample", "torch"):
        conf = dict(batch_size=32, max_seconds=1, dtype="int16", warmup=False,
                    top_db_mode=mode)
        with TaggingService(cfg, model, ServiceConfig(**conf), device=CARD) as svc:
            want = np.stack(svc.infer_many(pcm))
        torch.cuda.synchronize()
        reset_launches()
        with TaggingService(cfg, model, ServiceConfig(**conf, data_parallel=mesh),
                            device=CARD) as svc:
            got = np.stack(svc.infer_many(pcm))
            route = [svc._fwd.uses_kernel, svc._fwd.top_db_mode]
        counts[f"dp_serve_{mode}"] = dict(launches)
        rec[f"serve_{mode}"] = {"route": route,
                                "max_abs_diff_vs_non_dp": float(np.abs(got - want).max()),
                                "launches": counts[f"dp_serve_{mode}"]}
    rec["card"] = info["nvidia_smi"]
    emit(rec)
    check(rec["eval_fast"]["route"] == [True, "per_sample"]
          and rec["eval_exact"]["route"] == [True, "torch"]
          and rec["serve_per_sample"]["route"] == [True, "per_sample"]
          and rec["serve_torch"]["route"] == [True, "torch"]
          and rec["eval_fast"]["max_abs_diff_vs_non_dp_per_sample"] <= 1e-3
          and rec["eval_exact"]["max_abs_diff_vs_non_dp_exact"] <= 1e-3
          and all(rec[f"serve_{m}"]["max_abs_diff_vs_non_dp"] <= 1e-3
                  for m in ("per_sample", "torch"))
          and counts["dp_eval_fast"]["row_fast"] == 4
          and counts["dp_eval_exact"]["row_exact"] == 4
          and all(counts[f"dp_serve_{m}"]["row_fast"] >= 2 for m in ("per_sample", "torch")),
          f"in-process data parallelism: {rec}")
    return counts


# --------------------------------------------------------- model parallelism

MP_B = 32  # the dense routes' clips of 1 s; the EP routes take MOE_B clips of 10 s
# name: (route, its mesh over four ranks, options); at one rank each route
# runs on a mesh of ones (MP_ONE_RANK)
MP_ROUTES = {
    "tp": ("tp", {"data": 2, "model": 2}, {}),
    "tp_attn": ("tp", {"data": 2, "model": 2}, {"shard_attention": True}),
    "hybrid_step": ("hybrid_step", {"data": 2, "model": 2}, {}),
    "sp": ("sp", {"seq": 4}, {}),
    "sp_bf16": ("sp", {"seq": 4}, {"bf16": True}),
    "sp_fast": ("sp", {"seq": 4}, {"fast": True}),
    "sp_data": ("sp", {"data": 2, "seq": 2}, {}),
    "pp": ("pp", {"pipe": 4}, {"n_microbatches": 4}),
    "pp_m8": ("pp", {"pipe": 4}, {"n_microbatches": 8}),
    "pp_fast": ("pp", {"pipe": 4}, {"n_microbatches": 4, "fast": True}),
    "ep": ("ep", {"data": 2, "expert": 2}, {}),
    "ep_step": ("ep_step", {"data": 2, "expert": 2}, {}),
}
MP_ONE_RANK = ("tp", "hybrid_step", "sp", "pp", "ep", "ep_step")
# the tensor dims a step's ReLU inputs split over each mesh axis: the dense
# MLP's (rows, tokens, hidden), the experts' (experts, groups, slots, hidden)
MP_RELU_DIMS = {"hybrid_step": {"data": 0, "model": -1}, "ep_step": {"expert": 0, "data": 1}}


def mp_inputs(moe: bool, fast: bool = False):
    """The seeded global batch of a route: (wav as the route takes it: int16
    PCM for the fast routes, else float32; multi-hot targets)."""
    if moe:
        pcm, target = moe_batch(23)
    else:
        pcm = pcm_batch(np.random.default_rng(21), MP_B, SR)
        target = (np.random.default_rng(22).random((MP_B, 537)) < 0.05).astype(np.float32)
    return (pcm if fast else pcm.astype(np.float32) / 32768.0), target


def mp_model(moe: bool, bf16: bool = False, device="cpu"):
    """(cfg, model) of a route: uit_xs (outputdim 537, target_length 102) or
    uit_xs_moe (8 experts, top-2, target_length 1012), seeded weights."""
    from uit_mobile_tpu_torch import models

    if moe:
        cfg = models.get_model_config("uit_xs_moe", outputdim=537)
        return cfg, models.build(cfg, torch.Generator().manual_seed(31), device)
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102,
                                  compute_dtype="bfloat16" if bf16 else "float32")
    return cfg, models.build(cfg, torch.Generator().manual_seed(30), device)


def mp_variant(opts: dict) -> str:
    return "row_fast" if opts.get("fast") else "row_exact"


def param_bytes(model) -> int:
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
    return sum(local(p).numel() * p.element_size() for p in model.parameters())


def mp_route(route: str, shape: dict, opts: dict, dev) -> dict:
    """One route on this rank's share of the mesh ``shape``: counts set to 0
    just before its main path (one forward, or one step) and read just
    after; then the forward's CUDA-event median. -> its output (forward:
    probs; step: loss, pre-clip norm, gathered params and gradients, the
    ReLU signs), mel launches, ms, the weights this rank holds."""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ops import launches
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch import parallel
    from uit_mobile_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from uit_mobile_tpu_torch.parallel.tp import gather_params
    from uit_mobile_tpu_torch.train import build_optimizer

    moe = route.startswith("ep")
    cfg, model = mp_model(moe, opts.get("bf16", False))
    whole = param_bytes(model)
    fe = make_frontend_fn(cfg.frontend, precision="fast" if opts.get("fast") else "exact")
    wav, target = mp_inputs(moe, opts.get("fast", False))
    wav, target = torch.from_numpy(wav).to(dev), torch.from_numpy(target).to(dev)
    mesh = parallel.make_grid_mesh(shape, device=dev)
    data_axis = "data" if "data" in shape else None
    out = {"coords": mesh.coords, "whole_bytes": whole}
    if route.endswith("_step"):
        local, rows = mesh.shard_rows(wav, data_axis)
        tgt, _ = mesh.shard_rows(target, data_axis)
        opt_spec = build_optimizer("AdamW", DP_LR, weight_decay=5e-8)
        if route == "hybrid_step":
            root, _ = parallel.hybrid_shard_params(mesh, model)
            model = root.model
            opt = opt_spec.init(model)
            step = make_fsdp_train_step(cfg, root, opt, rows=rows, frontend_fn=fe)
            run = lambda: step({"wav": local, "target": tgt},  # noqa: E731
                               torch.Generator(device=dev).manual_seed(3))
        else:
            model, _ = parallel.ep_shard_params(mesh, model)
            opt, _ = parallel.sharded_opt_init(opt_spec, model)
            step = parallel.make_moe_train_step(cfg, model, opt, frontend_fn=fe, rows=rows)
            run = lambda: step(local, tgt, torch.Generator(device=dev).manual_seed(3))  # noqa
        grads, update = {}, opt.update
        opt.update = lambda g: (grads.update(zip(opt.names, g)), update(g))[1]
        signs: list = []
        restore = relu_signs(record=signs)
        try:
            torch.cuda.synchronize()
            reset_launches()
            m = run()
            torch.cuda.synchronize()
            out["launches"] = dict(launches)
        finally:
            restore()
        opt.update = update
        out.update(loss=m["total_loss"].item(), grad_norm=m["grad_norm"].item(),
                   params=gather_params(model), grads=gather_params(model, grads), signs=signs,
                   rank_bytes=param_bytes(model))
        out["step_ms"] = time_ms(run, warmup=1, iters=3)
        return out
    if route == "tp":
        fn = parallel.tensor_parallel_forward(
            lambda m, w: models.apply(cfg, m, w, frontend_fn=fe), mesh, model, **opts)
        held = param_bytes(model)
    elif route == "sp":
        fn = parallel.sequence_parallel_forward(cfg, model, mesh, data_axis=data_axis,
                                                frontend_fn=fe)
        held = param_bytes(model)
    elif route == "pp":
        blocks = sum(p.numel() * p.element_size() for p in model.blocks.parameters())
        fn = parallel.pipeline_forward(cfg, model, mesh, data_axis=data_axis, frontend_fn=fe,
                                       n_microbatches=opts["n_microbatches"])
        held = whole - blocks + blocks // shape["pipe"]
    else:
        fn = parallel.expert_parallel_forward(cfg, model, mesh, frontend_fn=fe)
        held = param_bytes(model)
    torch.cuda.synchronize()
    reset_launches()
    probs = fn(wav)
    torch.cuda.synchronize()
    out.update(launches=dict(launches), probs=probs.cpu(), on_card=probs.is_cuda,
               rank_bytes=held, ms=time_ms(lambda: fn(wav), warmup=1, iters=5))
    return out


def mp_rank(argv) -> int:
    """One rank of the model-parallel phase (``chip_smoke.py --mp-rank R W
    PORT DIR BACKEND DEVICE``): every route of MP_ROUTES (four ranks) or of
    MP_ONE_RANK on meshes of ones (one rank); results to DIR."""
    import torch.distributed as dist

    from uit_mobile_tpu_torch.parallel import multihost
    from uit_mobile_tpu_torch.utils import resolve_device

    global CARD
    rank, world, port, workdir, backend, CARD = (int(argv[0]), int(argv[1]), argv[2],
                                                 Path(argv[3]), argv[4], argv[5])
    dev = resolve_device(CARD)  # TF32 off, as in the single-process forwards and steps
    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device=dev,
                         backend=backend, timeout=PARALLEL_DEADLINE_S)
    res = {}
    for name, (route, shape, opts) in MP_ROUTES.items():
        if world == 1 and name not in MP_ONE_RANK:
            continue
        if world == 1:
            shape = {axis: 1 for axis in shape}
        res[name] = dict(mp_route(route, shape, opts, dev), mesh=shape)
    torch.save(res, workdir / f"mp_rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def mp_spawn(work: Path, world: int, backend: str, devices: list | None = None) -> list:
    """Run mp_rank on ``world`` processes, rank r on ``devices[r]`` (default:
    all sharing CARD) -> their results."""
    work.mkdir(parents=True, exist_ok=True)
    port = str(free_port())
    devices = devices or [CARD] * world
    spawn_ranks([[sys.executable, "-X", "faulthandler", str(REPO / "chip_smoke.py"), "--mp-rank",
                  str(r), str(world), port, str(work), backend, devices[r]]
                 for r in range(world)], PARALLEL_DEADLINE_S)
    return [torch.load(work / f"mp_rank{r}.pt", weights_only=False) for r in range(world)]


def assemble(per_rank: list, shape: dict, dims: dict) -> list:
    """Each rank's recorded tensors (one a call) -> the whole tensors, the
    pieces of the axes in ``dims`` concatenated on their dims in mesh order
    (an axis not in ``dims`` holds copies: its first is taken)."""
    out = []
    for i in range(len(per_rank[0]["signs"])):
        pieces = {tuple(r["coords"][a] for a in shape): r["signs"][i] for r in per_rank}

        def build(prefix, axes):
            if not axes:
                return pieces[prefix]
            parts = [build(prefix + (j,), axes[1:]) for j in range(shape[axes[0]])]
            return torch.cat(parts, dim=dims[axes[0]]) if axes[0] in dims else parts[0]

        out.append(build((), list(shape)))
    return out


def mp_single_step(route: str, impose: list | None = None) -> dict:
    """The route's step in one process on CARD (the weak step, or the MoE
    step), the whole batch and model; ``impose``: the ReLU signs to take
    (relu_signs) -> loss, pre-clip norm, params, gradients, ReLU signs."""
    from uit_mobile_tpu_torch import parallel
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    moe = route == "ep_step"
    cfg, model = mp_model(moe, device=CARD)
    fe = make_frontend_fn(cfg.frontend, precision="exact")
    wav, target = (torch.from_numpy(a).to(CARD) for a in mp_inputs(moe))
    opt = build_optimizer("AdamW", DP_LR, weight_decay=5e-8).init(model)
    grads = step_grads(opt)
    gen = torch.Generator(device=CARD).manual_seed(3)
    signs: list = []
    restore = relu_signs(record=None if impose is not None else signs, impose=impose)
    try:
        if moe:
            m = parallel.make_moe_train_step(cfg, model, opt, frontend_fn=fe)(wav, target, gen)
        else:
            m = make_train_step(cfg, model, opt, frontend_fn=fe)(
                {"wav": wav, "target": target}, gen)
        torch.cuda.synchronize()
    finally:
        restore()
    return {"loss": m["total_loss"].item(), "grad_norm": m["grad_norm"].item(),
            "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()},
            "grads": grads, "signs": signs}


def mp_references() -> dict:
    """The single-process forwards on CARD that the routes are held to, one
    per (model, precision, dtype), the same kernel frontend -> {key: (probs,
    ms)}."""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn

    refs = {}
    for key in ("dense", "dense_bf16", "dense_fast", "moe"):
        moe, fast = key == "moe", key == "dense_fast"
        cfg, model = mp_model(moe, bf16=key == "dense_bf16", device=CARD)
        fe = make_frontend_fn(cfg.frontend, precision="fast" if fast else "exact")
        wav = torch.from_numpy(mp_inputs(moe, fast)[0]).to(CARD)
        fwd = lambda: models.apply(cfg, model, wav, frontend_fn=fe)  # noqa: E731
        refs[key] = (fwd().cpu(), time_ms(fwd, warmup=1, iters=5))
    return refs


def mp_ref_key(route: str, opts: dict) -> str:
    if route.startswith("ep"):
        return "moe"
    return "dense_bf16" if opts.get("bf16") else "dense_fast" if opts.get("fast") else "dense"


def mp_step_gate(name: str, route: str, ranks: list, shape: dict, info, backend: str) -> dict:
    """The ranks' step against the single-process step on CARD, as the
    parallel phase's steps: without and given the ranks' ReLU signs (the
    flips counted); the ranks end alike, the loss within 1e-5 either way,
    the flips under 1e-5 of the ReLU inputs, and dp_agreement given the
    ranks' signs."""
    free = mp_single_step(route)
    rank_signs = assemble(ranks, shape, MP_RELU_DIMS[route])
    flips = int(sum((a != b).sum() for a, b in zip(rank_signs, free["signs"])))
    given = mp_single_step(route, impose=list(rank_signs))
    got = ranks[0]
    same = all(torch.equal(got["params"][k], r["params"][k]) for r in ranks[1:]
               for k in got["params"])
    rec = {"phase": "model_parallel", "path": f"{len(ranks)}_ranks_{name}", "backend": backend,
           "mesh": shape, "mel_launches_by_rank": [r["launches"] for r in ranks],
           "relu_inputs": int(sum(s.numel() for s in free["signs"])), "relu_flips": flips,
           "ranks_params_bitwise": same,
           "vs_single_given_rank_signs": dp_agreement(got, given),
           "vs_single": dp_agreement(got, free),
           "step_ms_by_rank": [r["step_ms"] for r in ranks],
           "weight_bytes_by_rank": [r["rank_bytes"] for r in ranks],
           "whole_model_bytes": got["whole_bytes"], "card": info["nvidia_smi"]}
    emit(rec)
    check(same and rec["vs_single_given_rank_signs"]["agrees"]
          and rec["vs_single"]["loss_rel_err"] <= 1e-5 and flips <= 1e-5 * rec["relu_inputs"],
          f"{name} at {len(ranks)} ranks vs one process: {rec}")
    return rec


def mp_check(world: int, ranks: list, backend: str, spawn_s: float, refs: dict, info) -> dict:
    """Every route the ranks ran, held to the single process (forwards: 2e-5
    in probabilities, bfloat16 5e-3; steps: mp_step_gate), each printed on
    a line of its own -> {path: mel launch counts}."""
    counts = {}
    for name in ranks[0]:
        route, _, opts = MP_ROUTES[name]
        shape = ranks[0][name]["mesh"]
        per = [r[name] for r in ranks]
        variant = mp_variant(opts)
        for r, rr in enumerate(per):
            counts[f"{world}_ranks_{name}_rank{r}"] = rr["launches"]
        check(all(rr["launches"][variant] == 1 and sum(rr["launches"].values()) == 1
                  for rr in per),
              f"{name} at {world} ranks: a rank did not launch {variant} once for its "
              f"rows: {[rr['launches'] for rr in per]}")
        if route.endswith("_step"):
            mp_step_gate(name, route, per, shape, info, backend)
            continue
        want, single_ms = refs[mp_ref_key(route, opts)]
        tol = 5e-3 if opts.get("bf16") else 2e-5
        diffs = [(rr["probs"] - want).abs().max().item() for rr in per]
        rec = {"phase": "model_parallel", "path": f"{world}_ranks_{name}",
               "backend": backend, "mesh": shape, "variant": variant,
               "mel_launches_by_rank": [rr["launches"] for rr in per],
               "max_abs_diff_vs_single": max(diffs), "tolerance": tol,
               "ms_by_rank": [rr["ms"] for rr in per], "single_ms": single_ms,
               "weight_bytes_by_rank": [rr["rank_bytes"] for rr in per],
               "whole_model_bytes": per[0]["whole_bytes"], "spawn_wall_s": spawn_s,
               "card": info["nvidia_smi"],
               "note": "ranks sharing one card over gloo time-slice it: not a scaling number"
               if backend == "gloo" else f"{world} NCCL rank(s), one card each"}
        emit(rec)
        check(all(rr["on_card"] for rr in per) and max(diffs) <= tol,
              f"{name} at {world} ranks vs one process: {rec}")
    return counts


def phase_model_parallel(info) -> dict:
    """Model parallelism on the one card (not a scaling measurement), each
    route with the mel kernel as its frontend on every rank:
    (a) one NCCL rank (a ``--mp-rank`` process): TP 1x1, hybrid 1x1 (one
        weak step), SP S=1, PP S=1, EP 1x1 (forward and one step);
    (b) four gloo ranks sharing the card, spawned once: TP 2x2 with and
        without shard_attention; hybrid FSDP x TP 2x2 (one weak step); SP
        seq=4 (6 tokens a rank) in float32 exact, bfloat16 and int16 fast,
        and data=2 x seq=2; PP pipe=4 (3 blocks a stage) at M=4 and M=8, and
        int16 fast; EP data=2 x expert=2 on uit_xs_moe (4 experts a rank),
        forward at B=32 x 10 s and one AdamW step.
    Forwards are held to the single-process card forward with the same
    frontend: 2e-5 in probabilities, 5e-3 in bfloat16; steps as the
    parallel phase's (dp_versus_single).
    Each rank's mel launches (counts set to 0 just before its main path),
    forward ms (CUDA-event median) and the weight bytes it holds are
    printed. -> {path: mel launch counts}."""
    import tempfile

    counts: dict = {}
    work = Path(tempfile.mkdtemp(prefix="uit_model_parallel_"))
    worlds = {}
    for world, backend in ((1, "nccl"), (4, "gloo")):
        t0 = time.perf_counter()
        worlds[world] = (mp_spawn(work / f"w{world}", world, backend), backend,
                         time.perf_counter() - t0)
    refs = mp_references()
    for world, (ranks, backend, spawn_s) in worlds.items():
        counts.update(mp_check(world, ranks, backend, spawn_s, refs, info))
    shutil.rmtree(work, ignore_errors=True)
    return counts


GATE_DEADLINE_S = 600  # the gate's process: 400 steps and two evaluations (~1 min on an H100)
GATE_MIN = {"mAPKWS": 0.80, "gsc_accuracy@0.2": 0.80}  # the JAX gate's pins


def gsc_tree(root: Path, rng) -> list:
    """A GSC-shaped wav tree as tests/test_prep.py builds it, the keyword
    clips the synthetic world's tones: two keywords (on, off) and two
    fillers (bed, cat), 6 clips a word, a _background_noise_ folder, and the
    validation (clip 3) and test (clips 4, 5) lists -> the test clips."""
    from uit_mobile_tpu_torch.data import write_wav
    from uit_mobile_tpu_torch.data.prep import LABEL_MAPS_GSC_AUDIOSET
    from uit_mobile_tpu_torch.data.synthworld import synth_clip

    valid, test = [], []
    for word in ("on", "off", "bed", "cat"):
        for i in range(6):
            clip = synth_clip(rng, LABEL_MAPS_GSC_AUDIOSET[word])
            write_wav(root / word / f"clip{i}.wav", clip.astype(np.float32) / 32768.0)
        valid.append(f"{word}/clip3.wav")
        test += [f"{word}/clip{i}.wav" for i in (4, 5)]
    write_wav(root / "_background_noise_" / "noise.wav", rng.standard_normal(SR) * 0.1)
    (root / "validation_list.txt").write_text("\n".join(valid) + "\n")
    (root / "testing_list.txt").write_text("\n".join(test) + "\n")
    return [str((root / t).absolute()) for t in test]


def phase_gate(info) -> dict:
    """The synthetic accuracy gate at full size on the card:
    ``python -m uit_mobile_tpu_torch.tools.gate_synthetic`` in its own
    process (killed at GATE_DEADLINE_S), which trains uit_xxxs through
    cli.train and scores it through cli.evaluate audioset and gsc, each
    call's mel launches counted from 0 in that process: exit 0, both scores
    at or above GATE_MIN, row_exact launched in training and in each
    evaluation (so no call fell back to the plain frontend). Then
    ``python -m uit_mobile_tpu_torch.cli.prep gsc`` writes a GSC-shaped wav
    tree to an .npz store, and cli.evaluate gsc (in this process, counts
    set to 0 just before) scores its test split with the gate's model on
    the card: every clip scored, every probability finite, row_exact
    launched. -> {path: mel launch counts}."""
    import importlib.util
    import tempfile

    from uit_mobile_tpu_torch.cli import evaluate as eval_cli
    from uit_mobile_tpu_torch.ops import launches

    work = Path(tempfile.mkdtemp(prefix="uit_gate_"))
    t0 = time.perf_counter()
    code, out = run_with_deadline(
        [sys.executable, "-m", "uit_mobile_tpu_torch.tools.gate_synthetic", "--device", "cuda",
         "--outdir", str(work / "gate")], GATE_DEADLINE_S)
    wall = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "gate.log").write_text(out)
    lines = [ln for ln in out.splitlines() if ln.startswith('{"gate"')]
    check(code == 0 and bool(lines), f"gate_synthetic exited {code}:\n{out[-4000:]}")
    gate = json.loads(lines[-1])
    counts = dict(gate["mel_launches"])
    rec = {"phase": "gate", **gate, "process_wall_s": wall,
           "modules_present": {m: importlib.util.find_spec(m) is not None
                               for m in ("h5py", "pandas", "yaml")}}
    check(all(gate[k] >= v for k, v in GATE_MIN.items()), f"gate scores under {GATE_MIN}: {rec}")
    check(all(c["row_exact"] > 0 for c in counts.values()),
          f"gate: a call never launched row_exact: {counts}")

    # cli.prep gsc -> an .npz store, scored by the gate's model on the card
    test_clips = gsc_tree(work / "gsc_raw", np.random.default_rng(60))
    code, out = run_with_deadline(
        [sys.executable, "-m", "uit_mobile_tpu_torch.cli.prep", "gsc", str(work / "gsc_raw"),
         str(work / "gsc"), "--store", "npz"], 120)
    check(code == 0, f"cli.prep gsc exited {code}:\n{out[-4000:]}")
    tsv = work / "gsc" / "labels" / "test_gsc_aslabels.tsv"
    dump = work / "prep_preds.npz"
    torch.cuda.synchronize()
    reset_launches()
    printed = cli_stdout(eval_cli.main, ["gsc", gate["checkpoint"], "--eval-data", str(tsv),
                                         "--dump-predictions", str(dump), "--device", "cuda"])
    torch.cuda.synchronize()
    counts["prep_gsc_evaluate"] = dict(launches)
    with np.load(dump, allow_pickle=True) as z:
        preds, names = z["preds"], [str(n) for n in z["filenames"]]
    rec["prep"] = {"store": sorted(p.name for p in (work / "gsc" / "hdf5").iterdir()),
                   "test_clips": len(test_clips), "scored": list(preds.shape),
                   "finite": bool(np.isfinite(preds).all()),
                   "result": printed[-1] if printed else None,
                   "launches": counts["prep_gsc_evaluate"]}
    rec["card"] = info["nvidia_smi"]
    emit(rec)
    check(preds.shape == (len(test_clips), 537) and rec["prep"]["finite"]
          and sorted(names) == sorted(test_clips)
          and counts["prep_gsc_evaluate"]["row_exact"] > 0,
          f"cli.prep's .npz set scored on the card: {rec['prep']}")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def mp_cards(argv) -> int:
    """``chip_smoke.py --mp-cards 4``: the model_parallel phase's four-rank
    routes as four NCCL ranks, one card each (the layouts' own setting:
    NCCL collectives and point to point on the cards), held by the same
    gates against the single process on the first card; the same lines,
    then the kernels' launches on these routes and the last line. Exits
    non-zero without four cards."""
    import tempfile

    n = int(argv[0]) if argv else 0
    if n != 4 or not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print("chip_smoke --mp-cards: takes 4, and needs four CUDA GPUs", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from uit_mobile_tpu_torch.utils import resolve_device

    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = phase_device()
    phase_build()
    work = Path(tempfile.mkdtemp(prefix="uit_model_parallel_cards_"))
    t0 = time.perf_counter()
    ranks = mp_spawn(work, n, "nccl", devices=[f"cuda:{r}" for r in range(n)])
    spawn_s = time.perf_counter() - t0
    counts = mp_check(n, ranks, "nccl", spawn_s, mp_references(), info)
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "model_parallel", "cards": n, "wall_s": time.perf_counter() - t0,
          "mel_launches": counts})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ops import mel as mel_ops
    from uit_mobile_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")  # also switches TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        wall[name] = time.perf_counter() - t0
        return out

    info = phase_device()
    timed("build", phase_build)
    records = timed("kernels", phase_kernels, dev)

    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
    cpu_model = models.build(cfg, torch.Generator().manual_seed(1234), device="cpu")
    gpu_model = models.build(cfg, torch.Generator().manual_seed(1234), device="cuda")
    serve_counts = timed("serve", phase_serve, cfg, cpu_model, info)
    exact_counts = timed("exact", phase_exact, cfg, cpu_model, gpu_model)
    timed("forward", phase_forward, cfg, gpu_model, records, info)
    train_counts, recipe_npz = timed("train", phase_train, info)
    bf16_counts = timed("bf16", phase_bf16, info)
    psl_cache_counts, offline_counts = timed("psl_cache", phase_psl_cache, info)
    sed_counts = timed("sed", phase_sed, info)
    pretrain_counts = timed("pretrain", phase_pretrain, info)
    export_counts = timed("export", phase_export, cfg, cpu_model, info)
    moe_counts = timed("moe", phase_moe, info)
    eval_counts = timed("eval", phase_eval, recipe_npz, OUT_DIR / "uit_xs_seed1234.npz", info)
    stream_counts = timed("stream", phase_stream, cfg, cpu_model, info)
    http_counts = timed("http", phase_http, cfg, cpu_model, info)
    timed("bench", phase_bench, info)
    parallel_counts = timed("parallel", phase_parallel, info)
    model_parallel_counts = timed("model_parallel", phase_model_parallel, info)
    gate_counts = timed("gate", phase_gate, info)
    emit({"phase_wall_s": wall})

    def timing(rec):
        return {"shape": f"B={rec['B']} x {rec['seconds']} s, {rec['input']} in",
                "ms": rec["kernel_ms"], "back_to_back_ms": rec["kernel_back_to_back_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "fp32_fma_bound_ms": rec["fp32_fma_bound_ms"],
                "library_ms": rec["library_ms"]}

    kernels = []
    for variant in ("row_exact", "row_fast", "tfb_exact", "tfb_fast"):
        rec, *others = records[variant]
        precision = variant.split("_")[1]
        path_counts = serve_counts if precision == "fast" else exact_counts
        kernels.append({
            "name": f"mel_{variant}", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[variant], "launches": path_counts[variant],
            "path": "serve" if precision == "fast" else "exact",
            "train_launches": {name: c[variant] for name, c in train_counts.items()},
            "eval_launches": {mode: c[variant] for mode, c in eval_counts.items()},
            "stream_launches": {f"S={S}": c[variant] for S, c in stream_counts.items()},
            "http_launches": http_counts[variant],
            "bf16_launches": bf16_counts[variant],
            "psl_cache_launches": psl_cache_counts[variant],
            "offline_launches": offline_counts[variant],
            "sed_launches": sed_counts[variant],
            "pretrain_launches": pretrain_counts[variant],
            "export_launches": export_counts[variant],
            "moe_launches": {path: c[variant] for path, c in moe_counts.items()},
            "parallel_launches": {path: c[variant] for path, c in parallel_counts.items()},
            "model_parallel_launches": {path: c[variant]
                                        for path, c in model_parallel_counts.items()},
            "gate_launches": {path: c[variant] for path, c in gate_counts.items()},
            "max_abs_err": rec["max_abs_err_all_shapes_db"],
            "tolerance": TOLERANCE[precision].format(mel_ops.TOL_ROUNDINGS[precision]),
            "mean_abs_err": rec["mean_abs_err_db"], "kernel_ms": rec["kernel_ms"],
            **timing(rec), "also_timed": [timing(r) for r in others],
            "library": "torch.stft -> power -> @ fb -> log10 (composite)",
            "card": info["nvidia_smi"]})
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of the parallel phase's shared-card check
        sys.exit(dp_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--mp-rank"]:  # a rank of the model_parallel phase
        sys.exit(mp_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--mp-cards"]:  # the model_parallel routes over four cards
        sys.exit(mp_cards(sys.argv[2:]))
    sys.exit(main())
