"""Train and eval steps, counterpart of ``uit_mobile_tpu/train/steps.py``.

One train step does what the reference's per-iteration closure does: the
frozen teacher scores the AudioSet rows (PSL), their targets are
overwritten, mixup lambdas are drawn, the student's train forward runs
(augments, the fused mel kernel forward only, init_bn in train mode),
then the loss, the backward pass, the pre-clip gradient norm, clipping and
the optimizer update. The step mutates the model and the optimizer in place
and returns its metrics as device tensors (no host sync).

The optimizers are ``torch.optim``'s foreach Adam, AdamW and SGD, the same
update rules as optax's (AdamW's ``p * (1 - lr * wd)`` before the Adam step
is optax's ``wd * p`` added to the Adam direction), and ``Adafactor``, a
port of optax 0.2.6's ``adafactor`` (``torch.optim.Adafactor`` is another
rule); ``Adam8bit`` takes Adafactor's rule, as in the JAX package. The
learning rate of update n is ``schedule(n)``, n counted before the update,
as optax counts it: the host writes it, with the update's other scalars,
into a device tensor that the update reads (``Optimizer``).
``wrap_optimizer`` adds a parameter EMA and gradient accumulation (the mean
of K micro-gradients per applied update); the schedule and the EMA advance
per applied update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import models
from ..augment.mixup import mixup_targets, sample_mixup_lambdas
from ..parallel import multihost
from ..parallel.collectives import capturable, capture_agreement
from ..parallel.rows import Rows, global_sum, sharded
from ..parallel.rows import current as current_rows
from ..utils.device import device_constant
from ..utils.profiling import span

# ------------------------------------------------------------------- losses


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    """The loss over the global batch (the ranks hold equal shares)."""
    rows = current_rows()
    if reduction == "mean":
        return x.mean() if rows is None else rows.mean(x.mean())
    if reduction == "sum":
        return global_sum(x.sum())
    raise ValueError(f"unknown reduction {reduction!r} (use 'mean' or 'sum')")


def _weight(weight):
    """``weight`` -> None, or fn(device) -> it as float32 on that device,
    moved once a device (``utils.device.device_constant``): a step on the
    card copies nothing from the host (a CUDA graph could not)."""
    if weight is None:
        return None
    w = np.asarray(weight, dtype=np.float32)
    key = ("loss_weight", w.shape, w.tobytes())
    return lambda device: device_constant(key, torch.float32, device, lambda: w)


def _bce_elements(probs: torch.Tensor, targets: torch.Tensor, eps: float) -> torch.Tensor:
    p = probs.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))


def bce_loss(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy on probabilities clamped to [eps, 1 - eps], the
    mean over every element (the models train on sigmoid outputs)."""
    return _bce_elements(probs, targets, eps).mean()


def _make_bce(weight=None, reduction: str = "mean", eps: float = 1e-7):
    """torch.nn.BCELoss on probabilities; ``weight`` multiplies each
    element's loss before the reduction."""
    w = _weight(weight)

    def loss(probs, targets):
        elt = _bce_elements(probs, targets, eps)
        if w is not None:
            elt = elt * w(elt.device)
        return _reduce(elt, reduction)

    return loss


def _make_ce(weight=None, reduction: str = "mean", label_smoothing: float = 0.0,
             eps: float = 1e-7):
    """Cross-entropy over probability outputs: log-probs renormalized with
    logsumexp, targets normalized to sum 1. The weighted mean divides by
    the unsmoothed weighted target mass, as in the JAX package."""
    w = _weight(weight)

    def loss(probs, targets):
        C = probs.shape[-1]
        logp = torch.log(probs.clamp(eps, 1.0))
        logp = logp - torch.logsumexp(logp, dim=-1, keepdim=True)
        t = targets / targets.sum(-1, keepdim=True).clamp(min=eps)
        ww = w(probs.device) if w is not None else torch.ones(C, device=probs.device)
        denom = global_sum((t * ww).sum()).clamp(min=eps)
        if label_smoothing > 0.0:
            t = (1.0 - label_smoothing) * t + label_smoothing / C
        per_sample = -(t * ww * logp).sum(-1)
        if reduction == "mean":
            return global_sum(per_sample.sum()) / denom
        return _reduce(per_sample, reduction)

    return loss


def _make_focal(gamma: float = 2.0, alpha: Optional[float] = None,
                reduction: str = "mean", eps: float = 1e-7):
    """Binary focal loss on probabilities: BCE modulated by (1-p_t)^gamma,
    with an optional class-balance factor alpha."""

    def loss(probs, targets):
        p = probs.clamp(eps, 1.0 - eps)
        pos = -targets * ((1.0 - p) ** gamma) * torch.log(p)
        neg = -(1.0 - targets) * (p ** gamma) * torch.log1p(-p)
        if alpha is not None:
            pos = alpha * pos
            neg = (1.0 - alpha) * neg
        return _reduce(pos + neg, reduction)

    return loss


LOSS_FACTORIES = {
    "BCELoss": _make_bce,
    "CrossEntropyLoss": _make_ce,
    "FocalLoss": _make_focal,
}


def make_loss(name: str, **loss_args):
    """Config ``loss:`` + ``loss_args:`` -> fn(probs, targets) -> scalar."""
    if name not in LOSS_FACTORIES:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(LOSS_FACTORIES)} "
                       "(losses operate on the models' probability outputs)")
    return LOSS_FACTORIES[name](**loss_args)


# --------------------------------------------------------------- optimizers


def params_ema(decay: float) -> float:
    """Validate a parameter-EMA decay: ``ema <- decay * ema + (1 - decay) *
    params`` after every applied update, starting from a real copy of the
    initial params."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")
    return float(decay)


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """optax's choice of the two axes a second moment is factored over
    (the two largest, by numpy's argsort), or None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def adafactor_decay(count: int, decay_offset: int, decay_rate: float) -> float:
    """The second moments' decay of update ``count`` (counted from 0), in
    float32 as optax computes it: 1 - (count + 1 - decay_offset) ** -decay_rate."""
    t = np.float32(count - decay_offset + 1)
    return float(np.float32(1.0) - t ** np.float32(-decay_rate))


class Adafactor(torch.optim.Optimizer):
    """optax 0.2.6's ``adafactor`` as a ``torch.optim`` rule, the chain
    ``scale_by_factored_rms`` -> ``clip_by_block_rms`` -> the learning rate
    -> ``scale_by_param_block_rms`` -> optional ``ema`` momentum (not
    debiased) -> optional ``add_decayed_weights`` -> descent:

    - second moments factored into row and column accumulators for leaves
      with two dims of at least ``min_dim_size_to_factor`` (the two largest
      dims), a full accumulator elsewhere, decayed by
      1 - (count + 1 - decay_offset) ** -decay_rate (float32, as optax);
    - the update's RMS clipped to ``clipping_threshold`` per leaf;
    - scaled by the lr and by max(RMS(param), 1e-3) per leaf;
    - ``weight_decay_rate`` adds wd * param after the lr (optax's order).

    The accumulators live in ``state[p]`` as ``v_row``, ``v_col`` and ``v``
    (optax's shapes: a (1,) placeholder where unused) and ``momentum``;
    ``dims`` holds the leaf's factored axes (None: a full accumulator),
    chosen once here. ``apply(grads, lr, decay, keep)`` is an update, its
    scalars given as 0-dim tensors (the port's ``Optimizer`` writes them on
    the device; ``adafactor_decay`` gives the decay of update n)."""

    def __init__(self, params, lr: float = 1e-3, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
                 factored: bool = True):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset, multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored))
        self.slots = ("v_row", "v_col", "v") + (("momentum",) if momentum is not None else ())
        for group in self.param_groups:
            for p in group["params"]:
                dims = _factored_dims(tuple(p.shape), factored, min_dim_size_to_factor)
                one = torch.zeros(1, dtype=p.dtype, device=p.device)
                st = self.state[p]
                if dims is None:
                    st.update(v_row=one, v_col=one.clone(), v=torch.zeros_like(p))
                else:
                    d1, d0 = dims
                    st.update(v_row=torch.zeros([n for i, n in enumerate(p.shape) if i != d0],
                                                dtype=p.dtype, device=p.device),
                              v_col=torch.zeros([n for i, n in enumerate(p.shape) if i != d1],
                                                dtype=p.dtype, device=p.device),
                              v=one)
                if momentum is not None:
                    st["momentum"] = torch.zeros_like(p)
                st["dims"] = dims

    @torch.no_grad()
    def apply(self, grads: list[torch.Tensor], lr, decay, keep) -> None:
        """One update of every parameter from ``grads`` (in parameter order)
        at ``lr``, with the second moments' ``decay`` and ``keep`` = 1 -
        decay: no host read."""
        grads = iter(grads)
        for group in self.param_groups:
            for p in group["params"]:
                self._update(group, p, next(grads), self.state[p], lr, decay, keep)

    @staticmethod
    def _update(h: dict, p: torch.Tensor, g: torch.Tensor, st: dict, lr, decay, keep) -> None:
        grad_sqr = g * g + h["eps"]
        if st["dims"] is not None:
            d1, d0 = st["dims"]
            st["v_row"].copy_(decay * st["v_row"] + keep * grad_sqr.mean(dim=d0))
            st["v_col"].copy_(decay * st["v_col"] + keep * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
            row_factor = (st["v_row"] / row_col_mean) ** -0.5
            col_factor = st["v_col"] ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            st["v"].copy_(decay * st["v"] + keep * grad_sqr)
            u = g * st["v"] ** -0.5
        if h["clipping_threshold"] is not None:
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / h["clipping_threshold"], min=1.0)
        u = u * lr
        if h["multiply_by_parameter_scale"]:
            rms = torch.sqrt((p * p).mean())
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        if h["momentum"] is not None:
            st["momentum"].copy_(h["momentum"] * st["momentum"] + (1.0 - h["momentum"]) * u)
            u = st["momentum"]
        if h["weight_decay_rate"] is not None:
            u = u + h["weight_decay_rate"] * p
        p.sub_(u)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``build_optimizer`` returns and ``wrap_optimizer`` extends;
    ``init(model)`` binds it to a model's parameters."""
    name: str
    schedule: Callable[[int], float]
    hparams: dict
    ema_decay: Optional[float] = None
    grad_accum: int = 1

    def init(self, model: torch.nn.Module) -> "Optimizer":
        return Optimizer(self, model)


class Optimizer:
    """The optimizer state of one model: the base rule (Adam, AdamW or SGD,
    ``torch.optim``'s foreach updates written out with their per-update
    scalars as tensors; or ``Adafactor``), the update count that drives the
    schedule, the parameter EMA and the gradient accumulator, all allocated
    at construction (``state_leaves`` is fixed for a spec and a model).

    A micro-step has a host side and a device side, so that a CUDA graph can
    hold the device side (``make_train_step``). ``plan(k)`` is the host side
    of the next k micro-steps: their kinds ('apply' on every
    ``grad_accum``-th, else 'accumulate'), the counters advanced, and each
    micro-step's scalars written into the (k, n) device tensor
    ``scalars(k)``: the lr ``schedule(count)`` read before the count
    advances, as optax reads it, the bias corrections and decays that follow
    from the count, and the accumulator's weights (optax computes the same
    values from its count inside the program; here they are the one host
    write a step needs). ``device_update(grads, kind, row)`` reads them from
    a row of that tensor and never reads the host. ``update(grads)`` is both
    for one micro-step. On the CPU every update is bitwise the one
    ``torch.optim``'s foreach rule gives with Python scalars
    (tests/test_torch_dispatch.py)."""

    def __init__(self, spec: OptimizerSpec, model: torch.nn.Module):
        self.spec = spec
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for p in self.params]
        self.count = 0  # applied updates (the schedule's and the EMA's clock)
        self.micro = 0  # micro-steps accumulated toward the next update
        self.device = self.params[0].device if self.params else torch.device("cpu")
        h = spec.hparams
        self.base = None
        if spec.name == "Adafactor":
            # allocates its factored accumulators itself (their shapes are
            # not the parameters')
            self.base = Adafactor(self.params, lr=0.0, **h)
            self._slots = self.base.slots
            self._state = {k: [self.base.state[p][k] for p in self.params] for k in self._slots}
            self._columns = ("lr", "decay", "keep")
        else:
            if spec.name == "SGD":
                # a zero trace makes the first update's trace the gradient,
                # as in optax (and keeps the state's leaves fixed from the start)
                self._slots = ("momentum_buffer",) if h["momentum"] else ()
                self._columns = ("neg_lr",)
            else:
                self._slots = ("exp_avg", "exp_avg_sq")
                self._columns = ("neg_step_size", "bc2_sqrt") + (
                    ("wd_scale",) if h["weight_decay"] else ())
            self._state = {k: zeros() for k in self._slots}
        if spec.grad_accum > 1:
            self._columns += ("acc_keep", "acc_new")
        self.ema = ([p.detach().clone() for p in self.params]
                    if spec.ema_decay is not None else None)
        self.acc = zeros() if spec.grad_accum > 1 else None
        self._scalars: dict = {}

    @property
    def moments(self) -> list[list[torch.Tensor]]:
        """The base rule's state per slot: Adam's first and second moments,
        SGD's momentum trace, or Adafactor's row, column and full second
        moments (and momentum)."""
        return [self._state[k] for k in self._slots]

    def scalars(self, k: int) -> torch.Tensor:
        """The (k, n) float32 tensor on the parameters' device that
        ``plan(k)`` writes: one per k, at a fixed address for the graphs
        that read it."""
        t = self._scalars.get(k)
        if t is None:
            t = self._scalars[k] = torch.zeros((k, len(self._columns)), dtype=torch.float32,
                                               device=self.device)
        return t

    def _host_scalars(self, apply: bool) -> list[float]:
        """The next micro-step's scalars from the host's count and micro
        (before they advance), in ``_columns``' order, each computed as
        torch.optim computes its Python scalar (it reaches the kernel as
        float32 either way)."""
        h, vals = self.spec.hparams, {}
        if self.acc is not None:
            vals.update(acc_keep=self.micro / (self.micro + 1), acc_new=1.0 / (self.micro + 1))
        if apply:
            lr = self.spec.schedule(self.count)
            if self.spec.name == "SGD":
                vals["neg_lr"] = -lr
            elif self.spec.name == "Adafactor":
                decay = adafactor_decay(self.count, self.base.defaults["decay_offset"],
                                        self.base.defaults["decay_rate"])
                vals.update(lr=lr, decay=decay, keep=1.0 - decay)
            else:
                t = float(self.count + 1)  # torch.optim's step, after its increment
                vals.update(neg_step_size=(lr / (1 - h["b1"] ** t)) * -1,
                            bc2_sqrt=(1 - h["b2"] ** t) ** 0.5,
                            wd_scale=1 - lr * h["weight_decay"])
        return [vals.get(c, 0.0) for c in self._columns]

    def plan(self, k: int) -> tuple[str, ...]:
        """The host side of the next k micro-steps -> their kinds (class
        docstring)."""
        kinds, rows = [], []
        for _ in range(k):
            apply = self.acc is None or self.micro + 1 == self.spec.grad_accum
            rows.append(self._host_scalars(apply))
            kinds.append("apply" if apply else "accumulate")
            self.count += apply
            self.micro = 0 if apply else self.micro + 1
        host = torch.tensor(rows, dtype=torch.float32)
        if self.device.type == "cuda":
            # pinned and asynchronous: ordered on the stream after the steps
            # that read the last values, before the ones that read these
            self.scalars(k).copy_(host.pin_memory(), non_blocking=True)
        else:
            self.scalars(k).copy_(host)
        return tuple(kinds)

    @torch.no_grad()
    def device_update(self, grads: list[torch.Tensor], kind: str, row: torch.Tensor) -> None:
        """The device side of one micro-step of ``kind``, its scalars in
        ``row`` (a row of ``scalars(k)``): no host read, no host sync."""
        s = dict(zip(self._columns, row.unbind()))
        grads = list(grads)
        if self.acc is not None:
            # running mean of the micro-gradients
            torch._foreach_mul_(self.acc, s["acc_keep"])
            torch._foreach_addcmul_(self.acc, grads, [s["acc_new"]] * len(grads))
            if kind == "accumulate":
                return
            grads = self.acc
        self._rule(grads, s)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        if self.ema is not None:
            d = self.spec.ema_decay
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)

    def _rule(self, grads: list[torch.Tensor], s: dict) -> None:
        """The base rule's update at the scalars ``s``: torch.optim's foreach
        ops, each Python scalar that changes between updates a 0-dim tensor
        (``_foreach_add_(p, g, alpha=-lr)`` as ``addcmul`` by -lr, and
        ``addcdiv_(p, m, d, step_size)`` as ``addcdiv_(p, step_size * m,
        d)``: the same float32 roundings on the CPU)."""
        h, params = self.spec.hparams, self.params
        if self.spec.name == "Adafactor":
            self.base.apply(grads, s["lr"], s["decay"], s["keep"])
        elif self.spec.name == "SGD":
            if h["momentum"]:
                bufs = self._state["momentum_buffer"]
                torch._foreach_mul_(bufs, h["momentum"])
                torch._foreach_add_(bufs, grads, alpha=1)
                grads = (torch._foreach_add(grads, bufs, alpha=h["momentum"])
                         if h["nesterov"] else bufs)
            torch._foreach_addcmul_(params, grads, [s["neg_lr"]] * len(params))
        else:
            exp_avgs, exp_avg_sqs = self._state["exp_avg"], self._state["exp_avg_sq"]
            if "wd_scale" in s:
                torch._foreach_mul_(params, s["wd_scale"])
            torch._foreach_lerp_(exp_avgs, grads, 1 - h["b1"])
            torch._foreach_mul_(exp_avg_sqs, h["b2"])
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - h["b2"])
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, s["bc2_sqrt"])
            torch._foreach_add_(denom, h["eps"])
            torch._foreach_addcdiv_(params, torch._foreach_mul(exp_avgs, s["neg_step_size"]),
                                    denom)

    def update(self, grads: list[torch.Tensor]) -> bool:
        """One micro-step, host and device side -> whether an update was
        applied."""
        (kind,) = self.plan(1)
        self.device_update(grads, kind, self.scalars(1)[0])
        return kind == "apply"

    def state_leaves(self) -> list[torch.Tensor]:
        leaves = [torch.tensor([self.count, self.micro], dtype=torch.int64)]
        for group in self.moments + [self.ema or [], self.acc or []]:
            leaves.extend(group)
        return leaves

    @torch.no_grad()
    def load_state_leaves(self, leaves: list[torch.Tensor]) -> None:
        mine = self.state_leaves()
        if len(leaves) != len(mine):
            raise ValueError(f"optimizer structure changed: snapshot has {len(leaves)} "
                             f"leaves, this optimizer has {len(mine)}")
        self.count, self.micro = (int(v) for v in leaves[0])
        for dst, src in zip(mine[1:], leaves[1:]):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"optimizer leaf shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def find_ema_params(optimizer: Optimizer) -> Optional[dict]:
    """name -> EMA tensor of an optimizer built with ``ema_decay``, or None."""
    return None if optimizer.ema is None else dict(zip(optimizer.names, optimizer.ema))


_OPTIMIZERS = ("Adam", "AdamW", "SGD", "Adafactor", "Adam8bit")
# optax.adafactor's options (the port's Adafactor takes them all but
# dtype_momentum and weight_decay_mask)
_ADAFACTOR_OPTIONS = ("min_dim_size_to_factor", "decay_rate", "decay_offset",
                      "multiply_by_parameter_scale", "clipping_threshold", "momentum",
                      "weight_decay_rate", "eps", "factored")


def build_optimizer(name: str, schedule_or_lr, **kwargs) -> OptimizerSpec:
    """Config ``optimizer:`` + ``optimizer_args:`` -> an OptimizerSpec.
    ``schedule_or_lr`` is a float or a function of the update count."""
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; known: {sorted(_OPTIMIZERS)}")
    if name == "Adam8bit":
        # a different update rule, not a quantized Adam: configs written for
        # the reference converge differently; say so loudly
        from ..utils import get_logger

        get_logger().warning(
            "optimizer 'Adam8bit' (bitsandbytes) has no analogue in the port; "
            "substituting Adafactor (optax.adafactor's rule), a different update rule "
            "with different convergence behavior. Use 'Adam'/'AdamW' for faithful "
            "reference dynamics, or 'Adafactor' to make this choice explicit.")
        name = "Adafactor"
    kwargs = dict(kwargs)
    kwargs.pop("lr", None)
    if name == "SGD":
        hparams = {"momentum": float(kwargs.pop("momentum", 0.0)),
                   "nesterov": bool(kwargs.pop("nesterov", False))}
    elif name == "Adafactor":
        hparams = {k: kwargs.pop(k) for k in _ADAFACTOR_OPTIONS if k in kwargs}
    else:
        hparams = {"b1": float(kwargs.pop("b1", 0.9)), "b2": float(kwargs.pop("b2", 0.999)),
                   "eps": float(kwargs.pop("eps", 1e-8)),
                   # optax.adam takes no weight_decay; the JAX registry's
                   # AdamW defaults it to 1e-2
                   "weight_decay": float(kwargs.pop("weight_decay", 1e-2))
                   if name == "AdamW" else 0.0}
    if kwargs:  # an unknown option fails loudly instead of training without it
        raise TypeError(f"{name} got unexpected options {sorted(kwargs)}")
    schedule = schedule_or_lr if callable(schedule_or_lr) else (lambda count, lr=float(schedule_or_lr): lr)
    return OptimizerSpec(name, schedule, hparams)


def wrap_optimizer(spec: OptimizerSpec, *, ema_decay: Optional[float] = None,
                   grad_accum: int = 1) -> OptimizerSpec:
    """Add the parameter EMA (``ema_decay``) and gradient accumulation
    (``grad_accum`` micro-batches per applied update) to a spec."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    return dataclasses.replace(
        spec, ema_decay=None if ema_decay is None else params_ema(ema_decay),
        grad_accum=int(grad_accum))


# -------------------------------------------------------------------- steps


def _norm(w: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 / 32768 (exact: a power of two)."""
    return w.float() * (1.0 / 32768.0) if w.dtype == torch.int16 else w


def _step_wav(w: torch.Tensor, wav_augment) -> torch.Tensor:
    """The step's wav dtype policy: with no wav augment int16 PCM rides raw
    into the forwards (every frontend folds the 1/32768 scale bitwise);
    a wav augment needs the normalized float32 convention."""
    if wav_augment is None and w.dtype == torch.int16:
        return w
    return _norm(w)


def global_norm(grads: list[torch.Tensor], groups=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element (optax.global_norm).
    ``groups``: per gradient, the process groups its tensor is split over
    (empty: whole on this rank; a model-parallel shard, parallel/tp.py); its
    squares are summed over them, so every rank gets the whole model's norm."""
    if not groups or not any(groups):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    import torch.distributed as dist

    sums: dict = {}  # one float64 sum per tuple of groups, in the parameters' order
    for g, over in zip(grads, groups):
        sums[tuple(over)] = sums.get(tuple(over), 0.0) + (g.double() ** 2).sum()
    total = 0.0
    for over, sq in sums.items():
        for group in over:
            dist.all_reduce(sq, group=group)
        total = total + sq
    return torch.sqrt(total).float()


def shard_groups(model, names) -> list:
    """Per parameter name, the process groups a model-parallel placement
    split it over (``model.shards``, parallel/tp.py)."""
    shards = getattr(model, "shards", {})
    return [tuple(g for _, _, g in shards.get(n, ())) for n in names]


def _group_mean(grads, rows) -> list[torch.Tensor]:
    """The global batch's gradients from every rank's: each rank
    differentiates the rank-identical global loss, whose all-reduces hand
    every rank the whole of its own rows' share, so the sum over the group
    is W x the gradient (one all-reduce of the flattened gradients)."""
    flat = rows.all_reduce(torch.cat([g.reshape(-1) for g in grads])) / rows.world
    return [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]


def update_from_loss(model, optimizer: Optimizer, loss: torch.Tensor, new_state,
                     max_grad_norm: Optional[float] = None, plan=None,
                     gathered=None) -> torch.Tensor:
    """The tail of every train step: the gradients of ``loss`` over the
    optimizer's parameters (those the config leaves unused, the cls token
    under mean pooling, get zero gradients, as JAX gives them), their
    pre-clip global norm, with ``max_grad_norm`` the scaling by ``min(1,
    max / (norm + 1e-6))``, the new BN state and the optimizer update ->
    the pre-clip norm. Under ``parallel.rows.sharded`` the gradients are
    the global batch's, the same on every rank. ``plan``: (kind, row) of a
    micro-step the host has planned (``Optimizer.plan``): only the device
    side of the update runs; None runs both. ``gathered``: (DataShards,
    whole tensors) of an FSDP placement's step (``parallel/fsdp.py``): the
    gradients of its sharded parameters are taken at the whole tensors the
    forward read and reduce-scattered to this rank's shards; the others
    are averaged over the rows' group as ever. Spans: the backward is
    ``uit.backward``, the norm and the update ``uit.optim.update``."""
    shards, whole = gathered or (None, [])
    at = shards.index if shards is not None else []  # the sharded parameters' positions
    inputs = list(optimizer.params)
    for i, t in zip(at, whole):
        inputs[i] = t
    with span("backward"):
        grads = list(torch.autograd.grad(loss, inputs, materialize_grads=True))
    if at:
        for i, g in zip(at, shards.reduce_scatter([grads[i] for i in at])):
            grads[i] = g
    rows = current_rows()
    rest = sorted(set(range(len(grads))) - set(at))
    if rows is not None and rest:
        for i, g in zip(rest, _group_mean([grads[i] for i in rest], rows)):
            grads[i] = g
    with span("optim.update"):
        gnorm = global_norm(grads, shard_groups(model, optimizer.names))
        if max_grad_norm is not None:
            grads = torch._foreach_mul(grads,
                                       torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0))
        models.load_state(model, new_state)
        if plan is None:
            optimizer.update(list(grads))
        else:
            optimizer.device_update(grads, *plan)
    return gnorm


def make_train_step(model_cfg, model, optimizer: Optimizer, *, loss_name: str = "BCELoss",
                    loss_args: Optional[dict] = None, mixup_alpha: Optional[float] = None,
                    max_grad_norm: Optional[float] = None, psl_cfg=None, psl_model=None,
                    distill_mode: str = "psl", distill_alpha: float = 1.0,
                    distill_classes: int = 527, psl_split: Optional[int] = None,
                    wav_augment: Optional[Callable] = None,
                    spec_augment: Optional[Callable] = None,
                    frontend_fn: Optional[Callable] = None,
                    psl_frontend_fn: Optional[Callable] = None,
                    rows: Optional[Rows] = None) -> Callable:
    """-> ``train_step(batch, generator) -> {'total_loss', 'grad_norm'}``.

    On the card the step's device side is one CUDA graph per batch shape
    and optimizer kind (``ops/graphs.py``), as the JAX step is one jitted
    program, in one process and over NCCL ``rows`` (``_graphable``); the
    host plans the optimizer's micro-step (``Optimizer.plan``) before each
    replay. On the CPU it runs eagerly. ``make_multi_step`` takes K of them
    as one graph.

    Without PSL the batch is ``{'wav': (B, T), 'target': (B, C)}``. With
    PSL it is either the same flat form with the AudioSet rows first
    (``psl_split`` of them) or ``{'audioset': {...}, 'kws': {...}}``: the
    teacher ``psl_model`` (eval mode, no grad) scores the AudioSet rows'
    unaugmented wave and its probabilities replace their first
    ``distill_classes`` target columns. ``distill_mode='soft'``: the teacher
    scores every row and the target becomes ``alpha * teacher + (1 - alpha)
    * target``. The pre-clip gradient norm is reported; with
    ``max_grad_norm`` the gradients are scaled by ``min(1, max / (norm +
    1e-6))``. ``rows``: the batch is this rank's share of a global batch
    (``parallel.rows``; PSL: its audioset rows, then its kws rows), and the
    step computes the global batch's step on every rank. ``model`` may be
    placed by TP (``parallel.shard_params``), FSDP or hybrid FSDP x TP
    (``parallel.fsdp_shard_params``, ``hybrid_shard_params``; the teacher
    stays whole): the FSDP step gathers the shards before the forward and
    reduce-scatters their gradients after the backward itself, on its
    device side, so it replays as one graph on NCCL too."""
    if distill_mode not in ("psl", "soft"):
        raise ValueError(f"distill_mode must be 'psl' or 'soft', got {distill_mode!r}")
    if (psl_cfg is None) != (psl_model is None):
        raise ValueError("PSL needs both psl_cfg and psl_model")
    if (psl_cfg is not None and psl_frontend_fn is None
            and getattr(model_cfg, "mel_layout", "bft") == "tfb"):
        raise ValueError(
            "mel_layout='tfb' training with a PSL teacher needs psl_frontend_fn= "
            "(the teacher reads 'bft' mel; build one with "
            "make_frontend_fn(psl_cfg.frontend, layout='tfb_to_bft'))")
    if isinstance(model_cfg, models.MoEUITConfig):
        raise TypeError(
            "the MoE variant trains through its own step (router aux loss, no train-mode "
            "augment path): build it with parallel.make_moe_train_step")
    loss_fn = make_loss(loss_name, **(loss_args or {}))
    shards = _data_shards(model, optimizer, rows)

    def teacher(wav):
        with torch.no_grad():
            return models.forward(psl_cfg, psl_model, wav,
                                  frontend_fn=psl_frontend_fn or frontend_fn)

    def step(batch, generator, kind, row):
        with sharded(rows):
            return _step(batch, generator, (kind, row))

    def _step(batch, generator, plan):
        if psl_cfg is not None:
            if "wav" in batch:
                wav, target, n_as = _step_wav(batch["wav"], wav_augment), batch["target"], psl_split
                if distill_mode == "psl" and not (n_as is not None and 0 < n_as <= wav.shape[0]):
                    raise ValueError(
                        "flat PSL batches need make_train_step(..., psl_split=<audioset rows "
                        f"at the front of the batch>) in (0, {wav.shape[0]}], got {n_as}")
            else:
                as_w, kws_w = batch["audioset"]["wav"], batch["kws"]["wav"]
                # int16 passes through only when both halves are int16
                if wav_augment is None and as_w.dtype == kws_w.dtype == torch.int16:
                    wav = torch.cat([as_w, kws_w])
                else:
                    wav = torch.cat([_norm(as_w), _norm(kws_w)])
                target = torch.cat([batch["audioset"]["target"], batch["kws"]["target"]])
                n_as = as_w.shape[0]
            # the teacher scores the unaugmented wave on purpose: the wav
            # augments belong to the student's train forward
            if distill_mode == "psl":
                y_teacher = teacher(wav[:n_as])
                target = target.clone()
                target[:n_as, :distill_classes] = y_teacher[:, :distill_classes]
            else:
                target = distill_alpha * teacher(wav) + (1.0 - distill_alpha) * target
        else:
            wav, target = _step_wav(batch["wav"], wav_augment), batch["target"]

        mixup_lamb = None
        if mixup_alpha is not None and mixup_alpha > 0.0:
            if generator is None:
                raise ValueError("mixup needs a torch.Generator")
            mixup_lamb = sample_mixup_lambdas(generator, wav.shape[0], mixup_alpha)
            target = mixup_targets(target, mixup_lamb)

        (probs, new_state), gathered = _placed_forward(
            shards, optimizer, models.forward, model_cfg, model, wav, train=True,
            generator=generator, mixup_lamb=mixup_lamb, wav_augment=wav_augment,
            spec_augment=spec_augment, frontend_fn=frontend_fn)
        loss = loss_fn(probs, target)
        gnorm = update_from_loss(model, optimizer, loss, new_state, max_grad_norm, plan,
                                 gathered)
        return {"total_loss": loss.detach(), "grad_norm": gnorm}

    return dispatch_step(step, optimizer, rows)


def _data_shards(model, optimizer: Optimizer, rows):
    """The FSDP placement's ``parallel.fsdp.DataShards`` of ``model`` (None:
    none). Its step runs on this rank's rows of the global batch, as JAX's
    runs on the batch sharded over the same axis."""
    from ..parallel.fsdp import data_shards

    shards = data_shards(model, optimizer.names)
    if shards is not None and rows is None:
        raise ValueError("an FSDP-placed model's step takes this rank's rows of the global "
                         "batch: pass rows= (parallel.rows.Rows over the 'data' group)")
    return shards


def _placed_forward(shards, optimizer: Optimizer, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` -> (its result, ``update_from_loss``'s
    ``gathered``): on an FSDP placement (``shards``) the forward reads the
    whole tensors of one all-gather of the shards. A ``frontend_fn`` among
    the keywords runs inside the span ``uit.frontend``."""
    frontend = kwargs.get("frontend_fn")
    if frontend is not None:
        def spanned(wav):
            with span("frontend"):
                return frontend(wav)

        kwargs["frontend_fn"] = spanned
    if shards is None:
        return fn(*args, **kwargs), None
    whole = shards.gather(optimizer.params)
    return shards.call(whole, fn, *args, **kwargs), (shards, whole)


def _graphable(optimizer: Optimizer, rows) -> bool:
    """Whether a step runs as CUDA graphs: on the card, where every
    collective it can meet runs on NCCL (``collectives.capturable``: those
    of ``rows``' group; without rows, in a process group, the default
    group's, whose backend a placement's axis groups share: TP's, EP's and
    FSDP's all-gather and reduce-scatter)."""
    if optimizer.device.type != "cuda":
        return False
    if rows is not None:
        return capturable(rows.group)
    return not multihost.is_initialized() or capturable(None)


def _agreement(optimizer: Optimizer, rows):
    """The ranks' agreement on each capture of a step in a process group
    (``collectives.capture_agreement``), else None."""
    if rows is None and not multihost.is_initialized():
        return None
    return capture_agreement(optimizer.device)


def dispatch_step(step: Callable, optimizer: Optimizer, rows) -> Callable:
    """``train_step(batch, generator)`` over the device side ``step(batch,
    generator, kind, row)``: the host plans one micro-step, then the device
    side runs, as a CUDA-graph replay where ``_graphable``. The attributes
    ``device_step``, ``optimizer``, ``rows`` and ``graphs`` are what
    ``make_multi_step`` reads."""
    from ..ops.graphs import graphed

    def body(batch, generator, kind):
        return step(batch, generator, kind, optimizer.scalars(1)[0])

    run = (graphed(body, optimizer.device, agree=_agreement(optimizer, rows))
           if _graphable(optimizer, rows) else body)

    def train_step(batch, generator: Optional[torch.Generator] = None) -> dict:
        with span("step.plan"):
            (kind,) = optimizer.plan(1)
        return run(batch, generator, kind)

    train_step.device_step, train_step.optimizer, train_step.rows = step, optimizer, rows
    train_step.graphs, train_step.batch_step = None if run is body else run, train_step
    return train_step


def with_device_side(fn: Callable, batch_step: Callable) -> Callable:
    """``fn``, a dispatched ``batch_step(batch, generator)`` called with
    other arguments (the MAE and MoE steps' positional tensors), with
    ``batch_step``'s attributes, so that ``make_multi_step`` takes it."""
    for name in ("device_step", "optimizer", "rows", "graphs", "batch_step"):
        setattr(fn, name, getattr(batch_step, name))
    return fn


def make_framewise_train_step(model_cfg, model, optimizer: Optimizer, *,
                              loss_name: str = "BCELoss", loss_args: Optional[dict] = None,
                              max_grad_norm: Optional[float] = None,
                              wav_augment: Optional[Callable] = None,
                              spec_augment: Optional[Callable] = None,
                              frontend_fn: Optional[Callable] = None,
                              rows: Optional[Rows] = None) -> Callable:
    """SED step -> ``train_step(batch, generator) -> {'total_loss',
    'grad_norm'}``: batch = {'wav': (B, T), 'target': (B, S, C)} per-segment
    strong-label targets (data.StrongFramewiseHDF5Dataset) against
    ``models.uit.forward_train_framewise``'s (B, tg, C) probabilities; the
    loss, backward, pre-clip norm, clipping and optimizer update of
    ``make_train_step``, dispatched as it is (a CUDA graph per batch shape
    and optimizer kind on the card, where ``_graphable``). No PSL or mixup:
    neither has per-segment targets. ``rows``: as in ``make_train_step``.

    The segment grid check compares shapes alone: it runs on the host at
    the first, eager call of each batch shape, before the update, and a
    replay's shapes are those of a call that passed it."""
    from ..models import uit as uit_model

    loss_fn = make_loss(loss_name, **(loss_args or {}))
    shards = _data_shards(model, optimizer, rows)

    def step(batch, generator, kind, row):
        with sharded(rows):
            wav, target = _step_wav(batch["wav"], wav_augment), batch["target"]
            (probs, new_state), gathered = _placed_forward(
                shards, optimizer, uit_model.forward_train_framewise, model_cfg, model, wav,
                generator=generator, wav_augment=wav_augment, spec_augment=spec_augment,
                frontend_fn=frontend_fn)
            if probs.shape != target.shape:
                raise ValueError(f"segment grid mismatch: model {tuple(probs.shape)} vs "
                                 f"targets {tuple(target.shape)} — chunk_length and "
                                 f"target_length must describe the same window")
            loss = loss_fn(probs, target)
            gnorm = update_from_loss(model, optimizer, loss, new_state, max_grad_norm,
                                     (kind, row), gathered)
        return {"total_loss": loss.detach(), "grad_norm": gnorm}

    return dispatch_step(step, optimizer, rows)


def make_multi_step(train_step: Callable) -> Callable:
    """K train steps in a row: ``multi(batches, generator)`` with a leading
    (K, ...) axis on every batch leaf -> metrics stacked over the K steps.
    Exactly K sequential ``train_step`` calls, for any train step. For a
    dispatched step (``make_train_step``, ``make_framewise_train_step``,
    ``make_mae_step``, ``make_moe_train_step``) on the card the K steps are one CUDA graph (one
    replay, as JAX's ``lax.scan`` is one program), the host writing the K
    micro-steps' scalars (their learning rates) before it; the metrics are
    (K,) device tensors. The SED, MAE and MoE steps carry the same device
    side, and take their K steps the same way (the MAE and MoE steps' batches
    a dict of their positional tensors: ``{'wav'}`` or ``{'wav', 'noise'}``,
    ``{'wav', 'target'}``). ``multi.body(batches, generator, kinds)`` is the
    device side the graph holds, ``multi.graphs`` its ``GraphedFn`` (None on
    the CPU, and for a step with no device side of its own)."""

    from ..ops.graphs import graphed

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    if not hasattr(train_step, "device_step"):  # a step with no device side of its own
        def sequential(batches: dict, generator: Optional[torch.Generator] = None) -> dict:
            K = next(iter(_leaves(batches))).shape[0]
            ms = [train_step(take(batches, i), generator) for i in range(K)]
            return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

        sequential.body, sequential.graphs = None, None
        return sequential

    step, optimizer = train_step.device_step, train_step.optimizer

    def body(batches, generator, kinds):
        rows = optimizer.scalars(len(kinds))
        ms = [step(take(batches, i), generator, kind, rows[i]) for i, kind in enumerate(kinds)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    run = (body if train_step.graphs is None
           else graphed(body, optimizer.device, agree=_agreement(optimizer, train_step.rows)))

    def multi(batches: dict, generator: Optional[torch.Generator] = None) -> dict:
        K = next(iter(_leaves(batches))).shape[0]
        with span("step.plan"):
            kinds = optimizer.plan(K)
        return run(batches, generator, kinds)

    multi.body, multi.graphs = body, None if run is body else run
    return multi


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def make_eval_step(model_cfg, frontend_fn: Optional[Callable] = None) -> Callable:
    """-> ``eval_step(model, wav) -> probs``: the eval forward (crop
    chunking engaged) under ``torch.inference_mode``. On an FSDP-placed
    model it raises a ``ValueError`` (``models.forward``): its eval forward
    is ``parallel.fsdp_forward``."""

    def eval_step(model, wav):
        return models.apply(model_cfg, model, wav, frontend_fn=frontend_fn)

    return eval_step
