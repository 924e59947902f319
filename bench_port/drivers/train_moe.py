"""Training steps of the MoE UiT through ``parallel/ep.py:make_moe_train_step``
(a CUDA graph a step on the card), AdamW, the exact mel kernel in the 'bft'
layout: the configuration run as the repository trains it.

Set-up makes ``host_batches`` batches of ``batch`` distinct clips of
``clip_seconds`` (int16, cut from a seeded scene) and their multi-hot
targets in pinned host memory; every step copies one to the card, as a
loader would hand it over. It drives the step through its first
``checked_steps`` steps (the first eager, the second captured and then
replayed, the rest replays) and keeps what the comparison reads: each
step's loss, the first gradient as the optimizer holds it (its first
moment over 1 - beta1), and the parameters and init_bn statistics after
the last of them. The window
then goes on with the same step object; at most ``in_flight`` steps are
queued ahead of the card.

The comparison, in two stages. The mel: the program's mel kernel on the
checked batches (the step's frontend, called on the same batches) against
``reference/uit.py:log_mel``, the largest gap in dB. The rest
(``reference/uit.py:train_loss`` with ``torch.optim.AdamW``, float32, TF32
off, the same weights and targets) follows the program from that mel:
top-2 routing is discontinuous, and the mel kernel's rounding alone
routes near-tied tokens otherwise than the reference's float32 mel does
(on the H100: 0 to 115 of 95,232 tokens a seed, none between the
float32 and float64 reference, none between the program and the
reference fed the program's mel), which moves the whole step as much as the control
does. Its numbers: the worst step's loss gap, relative; the median
leaf's gap of first-gradient norms and of the norms of the change after
``checked_steps`` steps, each over the larger of the leaf's reference
norm and the median leaf's (the worst leaves' gaps are printed beside
them; under Adam a small leaf's change moves with rounding alone, by up
to 6e-4 between the float32 and the float64 reference). Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both (the unused cls token and its position under mean pooling:
zero, so Adam moves them by weight decay alone).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import gen
from ..counts import flops
from ..harness import Check, run_for, span
from ..reference import uit as ref
from .common import build_model, leaf_gaps, model_config, program_config, sizes

KEYS = {"batch": 32, "clip_seconds": 10.0, "host_batches": 8, "scene_seconds": 120,
        "optimizer": {"lr": 1e-3, "weight_decay": 5e-8}, "checked_steps": 4,
        "in_flight": 2, "limits": {}}
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
BUFFERS = ("init_bn.mean", "init_bn.var")


def setup(ctx):
    return MoETrain(ctx)


class Batches:
    """The cell's host batches, made on the device from the seed."""

    def __init__(self, ctx, p: dict, cfg: dict):
        dev, sr = ctx.device, cfg["frontend"]["sample_rate"]
        B, n, k = p["batch"], int(p["clip_seconds"] * sr), p["host_batches"]
        scene = gen.audio(ctx.seed, int(p["scene_seconds"] * sr), dev)
        g = gen.generator(ctx.seed, dev, stream=3)
        starts = (torch.rand(k * B, generator=g, device=dev) * (scene.shape[0] - n)).long()
        wav = scene[starts[:, None] + torch.arange(n, device=dev)].reshape(k, B, n)
        target = gen.multihot(ctx.seed, k * B, cfg["outputdim"], dev).reshape(k, B, -1)
        pin = dev.type == "cuda"
        self.wav = [w.cpu().pin_memory() if pin else w.cpu() for w in wav]
        self.target = [t.cpu().pin_memory() if pin else t.cpu() for t in target]
        self.dev, self.n = dev, n

    def __getitem__(self, i: int):
        i %= len(self.wav)
        return (self.wav[i].to(self.dev, non_blocking=True),
                self.target[i].to(self.dev, non_blocking=True))


class MoETrain:
    def __init__(self, ctx):
        from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
        from uit_mobile_tpu_torch.parallel import make_moe_train_step
        from uit_mobile_tpu_torch.train import build_optimizer

        self.ctx, self.dev = ctx, ctx.device
        self.p = p = sizes(ctx, KEYS)
        self.cfg = cfg = model_config(ctx)
        weights = gen.weights(ref.param_specs(cfg), ctx.seed, self.dev)
        self.w0 = {k: v.detach().clone() for k, v in weights.items()}
        ctx.mark("weights")
        self.batches = Batches(ctx, p, cfg)
        ctx.mark("batches")
        pcfg = program_config(cfg)
        self.model = build_model(pcfg, weights, self.dev, train=True)
        opt = p["optimizer"]
        self.opt = build_optimizer("AdamW", opt["lr"],
                                   weight_decay=opt["weight_decay"]).init(self.model)
        self.fe = fe = make_frontend_fn(pcfg.frontend, precision="exact", layout="bft")
        self.step = make_moe_train_step(pcfg, self.model, self.opt, frontend_fn=fe)
        ctx.mark("step built")
        self.n_steps = 0
        self.losses = []
        for i in range(p["checked_steps"]):
            self.losses.append(self._step()["total_loss"])
            if i == 0:
                self.g1 = [m.detach().clone() / (1 - BETA1) for m in self.opt.moments[0]]
        state = dict(self.model.named_parameters())
        state.update(self.model.named_buffers())
        self.after = {k: v.detach().clone() for k, v in state.items()}
        self.mels = program_mels(fe, self.batches, p["checked_steps"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        ctx.mark("checked steps (eager, capture, replays)")

    def _step(self) -> dict:
        wav, target = self.batches[self.n_steps]
        self.n_steps += 1
        with span("train_step"):
            return self.step(wav, target)

    # -------------------------------------------------------------- window
    def window(self, seconds: float, tracer) -> dict:
        cuda = self.dev.type == "cuda"
        events: list = []

        def body():
            if len(events) >= self.p["in_flight"]:
                with span("wait_card"):
                    events.pop(0).synchronize()
            self._step()
            if cuda:
                events.append(torch.cuda.Event())
                events[-1].record()

        t0 = time.perf_counter()
        steps, _ = run_for(seconds, body)
        if cuda:
            torch.cuda.synchronize(self.dev)
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.start()
            with tracer.stretch():
                run_for(tracer.seconds, body)
            tracer.stop()
        B, n, fe = self.p["batch"], self.batches.n, self.cfg["frontend"]
        return {"window_s": t1 - t0, "attempted": steps, "failed": 0, "steps": steps,
                "batch": B, "flops": steps * flops.train_step_flops(self.cfg, B, n),
                "mel_bound_s": flops.mel_bound_s(fe, B, n)}

    # ---------------------------------------------------------- comparison
    def program_readings(self) -> dict:
        names = self.opt.names
        return {"loss": [float(x) for x in self.losses],
                "grad": dict(zip(names, self.g1)),
                "after": self.after}

    def close(self) -> None:
        self.step = self.opt = self.model = self.fe = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        got = self.program_readings()
        self.close()
        want = reference(self.cfg, self.p, self.w0, self.batches, mels=self.mels)
        detail: dict = {}
        numbers = {"mel_gap_db": mel_gap_db(self.cfg, self.mels, self.batches),
                   **gaps(got, want, self.w0, detail)}
        print(f"detail {detail}", file=sys.stderr)
        return [Check(k, v, self.p["limits"][k]) for k, v in numbers.items()]


def program_mels(fe, batches, n: int) -> list:
    """The program's mel of each of the first ``n`` batches (float32)."""
    with torch.no_grad():
        return [fe(batches[s][0]).float() for s in range(n)]


def mel_gap_db(cfg: dict, mels: list, batches) -> float:
    """The largest gap in dB between ``mels`` and the reference's mel of
    the same batches."""
    with torch.no_grad():
        return max(float((m - ref.log_mel(batches[s][0], cfg["frontend"], per_sample=False))
                         .abs().max()) for s, m in enumerate(mels))


def reference(cfg: dict, p: dict, w0: dict, batches, tf32: bool = False,
              half_batch: bool = False, dtype: torch.dtype = torch.float32,
              mels: Optional[list] = None) -> dict:
    """``checked_steps`` steps of the plain reference from ``w0`` on the
    cell's first batches -> its readings (as ``program_readings``). With
    ``mels``, step s reads ``mels[s]`` in place of its own mel of the
    batch. ``half_batch``: the fault of a step that drops half its rows;
    ``dtype`` float64: a witness of float32's rounding."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        params = {k: v.to(dtype).clone().requires_grad_(True) for k, v in w0.items()
                  if k not in BUFFERS}
        stats = {k: w0[k].to(dtype).clone() for k in BUFFERS}
        opt = p["optimizer"]
        adamw = torch.optim.AdamW(list(params.values()), lr=opt["lr"], betas=(BETA1, BETA2),
                                  eps=EPS, weight_decay=opt["weight_decay"], foreach=False)
        losses, grad = [], None
        for s in range(p["checked_steps"]):
            wav, target = batches[s]
            mel = (ref.log_mel(wav, cfg["frontend"], per_sample=False, dtype=dtype)
                   if mels is None else mels[s].to(dtype))
            if half_batch:
                mel, target = mel[: mel.shape[0] // 2], target[: target.shape[0] // 2]
            loss, _, _, mean, var = ref.train_loss(cfg, {**params, **stats}, mel,
                                                   target.to(dtype))
            adamw.zero_grad(set_to_none=False)
            loss.backward()
            for v in params.values():  # an unused leaf's gradient is zero
                if v.grad is None:
                    v.grad = torch.zeros_like(v)
            if s == 0:
                grad = {k: v.grad.detach().clone() for k, v in params.items()}
            adamw.step()
            stats = {"init_bn.mean": mean, "init_bn.var": var}
            losses.append(float(loss.detach()))
        after = {k: v.detach().clone() for k, v in params.items()}
        after.update(stats)
        return {"loss": losses, "grad": grad, "after": after}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gaps(got: dict, want: dict, w0: dict, detail: Optional[dict] = None) -> dict:
    """The numbers compared: the worst step's loss gap (relative), and the
    median leaf's gap of first-gradient norms and of change norms (each
    over the larger of the leaf's reference norm and the median leaf's).
    ``detail`` gets every step's loss gap and the worst leaves' gaps."""
    steps = [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in want["grad"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    leaves = [k for k, v in norms.items() if v >= floor]
    grad = leaf_gaps(leaves, [float(torch.linalg.vector_norm(got["grad"][k].double()))
                              for k in leaves], [norms[k] for k in leaves])

    def change(readings, k):
        return float(torch.linalg.vector_norm(readings["after"][k].double().cpu()
                                              - w0[k].double().cpu()))

    moved = leaves + list(BUFFERS)
    step = leaf_gaps(moved, [change(got, k) for k in moved], [change(want, k) for k in moved])
    if detail is not None:
        worst_g, worst_c = max(grad, key=grad.get), max(step, key=step.get)
        detail.update(loss_by_step=steps, grad_worst=(worst_g, grad[worst_g]),
                      change_worst=(worst_c, step[worst_c]))
    return {"loss_gap": max(steps), "grad_gap": float(np.median(list(grad.values()))),
            "change_gap": float(np.median(list(step.values())))}


def control(ctx) -> dict:
    """The control and the faults at the cell's size, in the program's
    place: the reference with TF32 on, and with half of each batch left
    out, each fed the program's mel; the program's own lower precision of
    the mel (its 'fast' kernel) for the mel's gap. Beside them, the
    witnesses of the rounding that the comparison stands against: the
    float32 reference judged against a float64 one, and the tokens of the
    first batch whose top-2 experts differ between the program, the
    float32 and the float64 reference, and the float32 reference fed the
    program's mel."""
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn

    p, cfg = sizes(ctx, KEYS), model_config(ctx)
    w0 = gen.weights(ref.param_specs(cfg), ctx.seed, ctx.device)
    batches = Batches(ctx, p, cfg)
    fe = program_config(cfg).frontend
    n = p["checked_steps"]
    mels = program_mels(make_frontend_fn(fe, precision="exact", layout="bft"), batches, n)
    fast = program_mels(make_frontend_fn(fe, precision="fast", layout="bft"), batches, n)
    want = reference(cfg, p, w0, batches, mels=mels)

    def read(**kw):
        detail: dict = {}
        out = gaps(reference(cfg, p, w0, batches, mels=mels, **kw), want, w0, detail)
        return dict(out, worst=[detail["grad_worst"], detail["change_worst"]])

    own = reference(cfg, p, w0, batches)
    detail: dict = {}
    witness = gaps(own, reference(cfg, p, w0, batches, dtype=torch.float64), w0, detail)
    return {"tf32": read(tf32=True), "half_batch": read(half_batch=True),
            "sound_reference_repeat": read(),
            "mel_fast": {"mel_gap_db": mel_gap_db(cfg, fast, batches)},
            "mel_program": {"mel_gap_db": mel_gap_db(cfg, mels, batches)},
            "own_mel_vs_program_mel": gaps(own, want, w0),
            "float32_vs_float64": dict(witness, worst=[detail["grad_worst"],
                                                       detail["change_worst"]]),
            "routing_flips": routing_flips(ctx, cfg, w0, batches)}


def routing_flips(ctx, cfg: dict, w0: dict, batches) -> dict:
    """Tokens of the first batch, each routed block's, whose ordered top-2
    experts differ between two forwards of the first step's weights
    (train mode): the program's own forward, and the reference's in
    float32, in float64, and in float32 on the program's mel."""
    from uit_mobile_tpu_torch.models import moe
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn

    wav, target = batches[0]
    pcfg = program_config(cfg)
    model = build_model(pcfg, {k: v.clone() for k, v in w0.items()}, ctx.device, train=True)
    fe = make_frontend_fn(pcfg.frontend, precision="exact", layout="bft")
    program: list = []
    top_k = moe._top_k

    def recorded(gates, k):
        v, i = top_k(gates, k)
        program.append(i.detach().clone())
        return v, i

    moe._top_k = recorded
    try:
        with torch.no_grad():
            moe.forward_with_aux(pcfg, model, wav, train=True, frontend_fn=fe)
            mel_program = fe(wav).float()
    finally:
        moe._top_k = top_k
    del model

    def routes(mel, dtype):
        out: list = []
        with torch.no_grad():
            ref.train_loss(cfg, {k: v.to(dtype) for k, v in w0.items()}, mel.to(dtype),
                           target.to(dtype), routes=out)
        return out

    r32 = routes(ref.log_mel(wav, cfg["frontend"], per_sample=False), torch.float32)
    r64 = routes(ref.log_mel(wav, cfg["frontend"], per_sample=False, dtype=torch.float64),
                 torch.float64)
    r32_program_mel = routes(mel_program, torch.float32)

    def flips(a, b):
        return sum(int((x.reshape(-1, 2) != y.reshape(-1, 2)).any(-1).sum())
                   for x, y in zip(a, b))

    return {"tokens": sum(int(x.reshape(-1, 2).shape[0]) for x in r32),
            "program_vs_float32": flips(program, r32),
            "program_vs_float64": flips(program, r64),
            "float32_vs_float64": flips(r32, r64),
            "program_vs_float32_on_its_mel": flips(program, r32_program_mel)}
