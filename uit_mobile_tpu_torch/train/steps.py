"""Train and eval steps, counterpart of ``uit_mobile_tpu/train/steps.py``.

One train step does what the reference's per-iteration closure does: the
frozen teacher scores the AudioSet rows (PSL), their targets are
overwritten, mixup lambdas are drawn, the student's train forward runs
(augments, the fused mel kernel forward only, init_bn in train mode),
then the loss, the backward pass, the pre-clip gradient norm, clipping and
the optimizer update. The step mutates the model and the optimizer in place
and returns its metrics as device tensors (no host sync).

The optimizers are ``torch.optim``'s Adam, AdamW and SGD, the same update
rules as optax's (AdamW's ``p * (1 - lr * wd)`` before the Adam step is
optax's ``wd * p`` added to the Adam direction), and ``Adafactor``, a port
of optax 0.2.6's ``adafactor`` (``torch.optim.Adafactor`` is another rule);
``Adam8bit`` takes Adafactor's rule, as in the JAX package. The learning rate of
update n is ``schedule(n)``, n counted before the update, as optax counts
it: the wrapper sets it on the param groups before each step.
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
from ..parallel.rows import Rows, global_sum, sharded
from ..parallel.rows import current as current_rows

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
    return None if weight is None else torch.as_tensor(weight, dtype=torch.float32)


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
            elt = elt * w.to(elt.device)
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
        ww = w.to(probs.device) if w is not None else torch.ones(C, device=probs.device)
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


class Adafactor(torch.optim.Optimizer):
    """optax 0.2.6's ``adafactor`` as a ``torch.optim`` rule, the chain
    ``scale_by_factored_rms`` -> ``clip_by_block_rms`` -> the learning rate
    -> ``scale_by_param_block_rms`` -> optional ``ema`` momentum (not
    debiased) -> optional ``add_decayed_weights`` -> descent:

    - second moments factored into row and column accumulators for leaves
      with two dims of at least ``min_dim_size_to_factor`` (the two largest
      dims), a full accumulator elsewhere, decayed by
      1 - (step + 1 - decay_offset) ** -decay_rate (float32, as optax);
    - the update's RMS clipped to ``clipping_threshold`` per leaf;
    - scaled by the lr and by max(RMS(param), 1e-3) per leaf;
    - ``weight_decay_rate`` adds wd * param after the lr (optax's order).

    The accumulators live in ``state[p]`` as ``v_row``, ``v_col`` and ``v``
    (optax's shapes: a (1,) placeholder where unused) and ``momentum``;
    ``step`` counts the updates, as Adam's does; ``dims`` holds the leaf's
    factored axes (None: a full accumulator), chosen once here."""

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
                st["step"], st["dims"] = torch.tensor(0.0), dims

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(group, p, p.grad, self.state[p])

    @staticmethod
    def _update(h: dict, p: torch.Tensor, g: torch.Tensor, st: dict) -> None:
        t = np.float32(int(st["step"]) - h["decay_offset"] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-h["decay_rate"]))
        grad_sqr = g * g + h["eps"]
        if st["dims"] is not None:
            d1, d0 = st["dims"]
            st["v_row"].copy_(decay * st["v_row"] + (1.0 - decay) * grad_sqr.mean(dim=d0))
            st["v_col"].copy_(decay * st["v_col"] + (1.0 - decay) * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
            row_factor = (st["v_row"] / row_col_mean) ** -0.5
            col_factor = st["v_col"] ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            st["v"].copy_(decay * st["v"] + (1.0 - decay) * grad_sqr)
            u = g * st["v"] ** -0.5
        if h["clipping_threshold"] is not None:
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / h["clipping_threshold"], min=1.0)
        u = u * h["lr"]
        if h["multiply_by_parameter_scale"]:
            rms = torch.sqrt((p * p).mean())
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        if h["momentum"] is not None:
            st["momentum"].copy_(h["momentum"] * st["momentum"] + (1.0 - h["momentum"]) * u)
            u = st["momentum"]
        if h["weight_decay_rate"] is not None:
            u = u + h["weight_decay_rate"] * p
        p.sub_(u)
        st["step"] += 1


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
    """The optimizer state of one model: ``torch.optim``'s Adam, AdamW or
    SGD (``foreach``), or ``Adafactor``, as the base rule, the update count that drives the
    schedule, the parameter EMA and the gradient accumulator, all allocated
    at construction (``state_leaves`` is fixed for a spec and a model).
    ``update(grads)`` takes one micro-step's gradients; it applies an
    update to the parameters on every ``grad_accum``-th call, at the lr
    ``schedule(count)`` read before the count advances, as optax reads it."""

    def __init__(self, spec: OptimizerSpec, model: torch.nn.Module):
        self.spec = spec
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for p in self.params]
        self.count = 0  # applied updates (the schedule's and the EMA's clock)
        self.micro = 0  # micro-steps accumulated toward the next update
        h = spec.hparams
        if spec.name == "SGD":
            self.base = torch.optim.SGD(self.params, lr=0.0, momentum=h["momentum"],
                                        nesterov=h["nesterov"], foreach=True)
            # a zero trace makes the first update's trace the gradient, as
            # in optax (and keeps the state's leaves fixed from the start)
            self._slots = ("momentum_buffer",) if h["momentum"] else ()
        elif spec.name == "Adafactor":
            # allocates its factored accumulators itself (their shapes are
            # not the parameters')
            self.base = Adafactor(self.params, lr=0.0, **h)
            self._slots = self.base.slots
        else:
            rule = torch.optim.AdamW if spec.name == "AdamW" else torch.optim.Adam
            self.base = rule(self.params, lr=0.0, betas=(h["b1"], h["b2"]), eps=h["eps"],
                             weight_decay=h["weight_decay"], foreach=True)
            self._slots = ("exp_avg", "exp_avg_sq")
        for p in self.params if spec.name != "Adafactor" else ():
            self.base.state[p].update({k: torch.zeros_like(p, memory_format=torch.preserve_format)
                                       for k in self._slots})
            if spec.name != "SGD":
                self.base.state[p]["step"] = torch.tensor(0.0)
        self.ema = ([p.detach().clone() for p in self.params]
                    if spec.ema_decay is not None else None)
        self.acc = zeros() if spec.grad_accum > 1 else None

    @property
    def moments(self) -> list[list[torch.Tensor]]:
        """The base rule's state per slot: Adam's first and second moments,
        SGD's momentum trace, or Adafactor's row, column and full second
        moments (and momentum)."""
        return [[self.base.state[p][k] for p in self.params] for k in self._slots]

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> bool:
        """One micro-step -> whether an update was applied."""
        if self.acc is not None:
            # running mean of the micro-gradients
            torch._foreach_mul_(self.acc, self.micro / (self.micro + 1))
            torch._foreach_add_(self.acc, grads, alpha=1.0 / (self.micro + 1))
            self.micro += 1
            if self.micro < self.spec.grad_accum:
                return False
            grads, self.micro = self.acc, 0
        for group in self.base.param_groups:
            group["lr"] = self.spec.schedule(self.count)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.base.step()
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        self.count += 1
        if self.ema is not None:
            d = self.spec.ema_decay
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)
        return True

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
        for p in self.params:  # Adam's bias corrections count applied updates
            if "step" in self.base.state[p]:
                self.base.state[p]["step"].fill_(self.count)


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
        g = g.to_local() if hasattr(g, "to_local") else g
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
                     max_grad_norm: Optional[float] = None) -> torch.Tensor:
    """The tail of every train step: the gradients of ``loss`` over the
    optimizer's parameters (those the config leaves unused, the cls token
    under mean pooling, get zero gradients, as JAX gives them), their
    pre-clip global norm, with ``max_grad_norm`` the scaling by ``min(1,
    max / (norm + 1e-6))``, the new BN state and the optimizer update ->
    the pre-clip norm. Under ``parallel.rows.sharded`` the gradients are
    the global batch's, the same on every rank."""
    grads = torch.autograd.grad(loss, optimizer.params, materialize_grads=True)
    rows = current_rows()
    if rows is not None:
        grads = _group_mean(grads, rows)
    gnorm = global_norm(grads, shard_groups(model, optimizer.names))
    if max_grad_norm is not None:
        grads = torch._foreach_mul(grads, torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0))
    models.load_state(model, new_state)
    optimizer.update(list(grads))
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
    step computes the global batch's step on every rank."""
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

    def teacher(wav):
        with torch.no_grad():
            return models.forward(psl_cfg, psl_model, wav,
                                  frontend_fn=psl_frontend_fn or frontend_fn)

    def train_step(batch, generator: Optional[torch.Generator] = None) -> dict:
        with sharded(rows):
            return step(batch, generator)

    def step(batch, generator):
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

        probs, new_state = models.forward(
            model_cfg, model, wav, train=True, generator=generator, mixup_lamb=mixup_lamb,
            wav_augment=wav_augment, spec_augment=spec_augment, frontend_fn=frontend_fn)
        loss = loss_fn(probs, target)
        gnorm = update_from_loss(model, optimizer, loss, new_state, max_grad_norm)
        return {"total_loss": loss.detach(), "grad_norm": gnorm}

    return train_step


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
    ``make_train_step``. No PSL or mixup: neither has per-segment
    targets. ``rows``: as in ``make_train_step``."""
    from ..models import uit as uit_model

    loss_fn = make_loss(loss_name, **(loss_args or {}))

    def train_step(batch, generator: Optional[torch.Generator] = None) -> dict:
        with sharded(rows):
            return step(batch, generator)

    def step(batch, generator):
        wav, target = _step_wav(batch["wav"], wav_augment), batch["target"]
        probs, new_state = uit_model.forward_train_framewise(
            model_cfg, model, wav, generator=generator, wav_augment=wav_augment,
            spec_augment=spec_augment, frontend_fn=frontend_fn)
        if probs.shape != target.shape:
            raise ValueError(f"segment grid mismatch: model {tuple(probs.shape)} vs targets "
                             f"{tuple(target.shape)} — chunk_length and target_length must "
                             f"describe the same window")
        loss = loss_fn(probs, target)
        gnorm = update_from_loss(model, optimizer, loss, new_state, max_grad_norm)
        return {"total_loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_multi_step(train_step: Callable) -> Callable:
    """K train steps in a row: ``multi(batches, generator)`` with a leading
    (K, ...) axis on every batch leaf -> metrics stacked over the K steps.
    Exactly K sequential ``train_step`` calls."""

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    def multi(batches: dict, generator: Optional[torch.Generator] = None) -> dict:
        K = next(iter(_leaves(batches))).shape[0]
        ms = [train_step(take(batches, i), generator) for i in range(K)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return multi


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def make_eval_step(model_cfg, frontend_fn: Optional[Callable] = None) -> Callable:
    """-> ``eval_step(model, wav) -> probs``: the eval forward (crop
    chunking engaged) under ``torch.inference_mode``."""

    def eval_step(model, wav):
        return models.apply(model_cfg, model, wav, frontend_fn=frontend_fn)

    return eval_step
