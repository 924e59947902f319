"""The routed MLP's dispatch and combine by slot index (models/moe.py:
``_slot_maps``, ``_Dispatch``, ``_Combine``) against the dense one-hot
formulation it replaced, kept here as the reference: the JAX package's
(G, S, E, C) dispatch and combine tensors and their einsums.

The same block weights and input through both, on the CPU: the output, the
aux loss and the gradients of x, the router kernel and fc1/fc2 agree within
1e-5 of each tensor's largest element in float32 (the dense GEMM and the
gather sum the same k products in another rounding) and 2e-3 in bfloat16
(the port's bf16 budget, tests/test_torch_bf16.py); every (token, choice)
takes the dense form's slot exactly. Then the structure: no tensor saved
for the backward has G*S*E*C elements, and two backward passes of the same
inputs give bitwise-equal gradients.
"""

import math

import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.models import moe, uit
from uit_mobile_tpu_torch.models.common import ACTIVATIONS

torch.set_num_threads(1)

WEIGHTS = ("router.kernel", "fc1.kernel", "fc1.bias", "fc2.kernel", "fc2.bias")


def dense_moe_mlp(cfg, p, x):
    """The dense one-hot routed MLP (one rank, whole banks) -> (y, aux,
    dispatch (G, S, E, C))."""
    B, N, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cdt = uit.compute_dtype(cfg.base)
    S = moe._group_size(cfg, B, N)
    C = max(1, min(int(math.ceil(k * S / E * cfg.capacity_factor)), k * S))
    G = B * N // S
    gates = torch.softmax(torch.einsum("td,de->te", x.reshape(B * N, D).float(),
                                       p.router.kernel), dim=-1)
    topv, topi = moe._top_k(gates, k)
    topv = (topv / topv.sum(dim=-1, keepdim=True)).reshape(G, S, k)
    flat_topi, topi = topi, topi.reshape(G, S, k)
    xt = x.reshape(G, S, D)
    experts = torch.arange(E)
    slots = torch.arange(C, dtype=torch.float32)
    counts = torch.zeros(G, E)
    combine = torch.zeros(G, S, E, C)
    for j in range(k):
        oh = (topi[:, :, j, None] == experts).float()  # (G, S, E)
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        keep = oh * (pos < C)
        slot = (pos[..., None] == slots).float()  # zeros past the capacity
        combine = combine + topv[:, :, j, None, None] * keep[..., None] * slot
        counts = counts + oh.sum(dim=1)
    dispatch = (combine > 0).float()
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(cdt), xt.to(cdt))
    h = ACTIVATIONS[cfg.base.act](
        torch.einsum("egcd,edh->egch", expert_in, p.fc1.kernel.to(cdt))
        + p.fc1.bias.to(cdt)[:, None, None, :])
    out_e = (torch.einsum("egch,ehd->egcd", h, p.fc2.kernel.to(cdt))
             + p.fc2.bias.to(cdt)[:, None, None, :])
    y = torch.einsum("gsec,egcd->gsd", combine.to(cdt), out_e)
    f = (flat_topi[:, 0, None] == experts).float().mean(dim=0)
    aux = E * torch.sum(f * gates.mean(dim=0))
    return y.reshape(B, N, D).to(x.dtype), aux, dispatch.bool()


def _block(seed=0, uniform=False, **kw):
    """One routed block of a small uit_xs_moe (D=128, 4 experts) with drawn
    biases, so that an empty slot's expert output is not zero."""
    kw.setdefault("n_experts", 4)
    cfg = models.get_model_config("uit_xs_moe", outputdim=37, target_length=102, depth=1, **kw)
    p = models.build(cfg, torch.Generator().manual_seed(seed), "cpu").blocks[0].moe
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for lin in (p.fc1, p.fc2):
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=g))
        if uniform:
            p.router.kernel.zero_()
    return cfg, p


def _grads(fn, cfg, p, x, r, aux_weight=0.3):
    """fn's (y, aux, the gradients of x and the block's weights) under the
    loss sum(y * r) + aux_weight * aux."""
    x = x.clone().requires_grad_(True)
    for w in p.parameters():
        w.grad = None
    y, aux = fn(cfg, p, x)[:2]
    ((y.float() * r).sum() + aux_weight * aux).backward()
    return [y.detach(), aux.detach(), x.grad] + [p.get_parameter(n).grad for n in WEIGHTS]


CASES = {
    "capacity_2": {},
    "capacity_quarter": {"capacity_factor": 0.25},
    "top1": {"top_k": 1},
    "top1_capacity_quarter": {"top_k": 1, "capacity_factor": 0.25},
    "group_size_24": {"group_size": 24},
    "group_size_24_capacity_quarter": {"group_size": 24, "capacity_factor": 0.25},
    "uniform_router": {"uniform": True},
    "uniform_router_capacity_quarter": {"uniform": True, "capacity_factor": 0.25},
    "bfloat16": {"compute_dtype": "bfloat16"},
    "bfloat16_capacity_quarter": {"compute_dtype": "bfloat16", "capacity_factor": 0.25},
}


@pytest.mark.parametrize("case", list(CASES))
def test_slot_maps_match_the_dense_one_hot_form(case):
    cfg, p = _block(**CASES[case])
    B, N, D = 16, 12, 128  # auto groups: 8 clips, G = 2
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, N, D, generator=g)
    r = torch.randn(B, N, D, generator=g)
    got, want = _grads(moe.moe_mlp, cfg, p, x, r), _grads(dense_moe_mlp, cfg, p, x, r)
    tol = 2e-3 if cfg.compute_dtype == "bfloat16" else 1e-5
    noise = {}
    if cfg.top_k == 1:
        # a renormalized top-1 weight is v / v = 1: the gradient y sends the
        # router through it is zero, computed in either form as the rounding
        # of g / v - g * v / v**2, which an ulp of g moves; that noise, read
        # from y's term alone, is allowed on top of the bound
        alone = [_grads(fn, cfg, p, x, r, aux_weight=0.0)[3]
                 for fn in (moe.moe_mlp, dense_moe_mlp)]
        noise["router.kernel"] = max(float(a.abs().max()) for a in alone)
        assert noise["router.kernel"] <= 1e-3 * float(want[3].abs().max())
    for name, a, b in zip(("y", "aux", "x") + WEIGHTS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        gap = float((a.float() - b.float()).abs().max())
        assert gap <= tol * float(b.float().abs().max()) + noise.get(name, 0.0), (name, gap)

    # every (token, choice) takes the dense form's slot, every slot its token
    with torch.no_grad():
        routes = moe._route(cfg, p, x)
        dispatch = dense_moe_mlp(cfg, p, x)[2]
    G, S, E, C = dispatch.shape
    k, bank = cfg.top_k, E * G * C
    assert routes.slot_of.shape == (G * S, k) and routes.choice_of.shape == (bank,)
    assert routes.slot_of.dtype == routes.choice_of.dtype == torch.int32
    gates = torch.softmax(torch.einsum("td,de->te", x.reshape(-1, D), p.router.kernel), dim=-1)
    topi = moe._top_k(gates, k)[1].reshape(G, S, k)
    taken = dispatch[torch.arange(G)[:, None, None], torch.arange(S)[None, :, None], topi]
    slot_of = torch.where(taken.any(-1), (topi * G + torch.arange(G)[:, None, None]) * C
                          + taken.int().argmax(-1), bank)
    assert torch.equal(routes.slot_of, slot_of.reshape(G * S, k).int())
    by_slot = dispatch.permute(2, 0, 3, 1)  # (E, G, C, S)
    token_of = torch.where(by_slot.any(-1), torch.arange(G)[:, None] * S
                           + by_slot.int().argmax(-1), G * S)
    assert torch.equal(torch.div(routes.choice_of, k, rounding_mode="floor"),
                       token_of.reshape(-1).int())
    placed = routes.slot_of.reshape(-1) < bank
    choices = torch.arange(G * S * k, dtype=torch.int32)
    assert torch.equal(routes.choice_of[routes.slot_of.reshape(-1)[placed].long()],
                       choices[placed])
    if "capacity_quarter" in case:
        assert not placed.all()  # the capacity really binds
    stats = moe.routing_stats(cfg, p, x)
    n = int(dispatch.sum())
    assert stats == {"kept_share": n / (k * B * N), "filled_share": n / bank}


def test_no_saved_tensor_holds_a_dense_routing_tensor():
    """One block's routed MLP at S = 2,048 tokens a group (more than the
    expert width H = 512, so that the bank's (E, G, C, H) activations are
    smaller than one (G, S, E, C) tensor): no tensor saved for its backward
    has G*S*E*C elements or more."""
    cfg, p = _block()
    x = torch.randn(8, 256, 128, generator=torch.Generator().manual_seed(3), requires_grad=True)
    routes = moe._route(cfg, p, x.detach())
    G, S, E = 1, 2048, cfg.n_experts
    C = routes.choice_of.numel() // (E * G)
    assert moe._group_size(cfg, 8, 256) == S and C == 2048
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, aux = moe.moe_mlp(cfg, p, x)
    assert saved and max(saved) < G * S * E * C, (max(saved), G * S * E * C)
    (y.sum() + aux).backward()
    assert x.grad is not None and p.router.kernel.grad is not None


@pytest.mark.parametrize("capacity_factor", [0.25, 2.0])
def test_two_backward_passes_are_bitwise_equal(capacity_factor):
    cfg, p = _block(capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(16, 12, 128, generator=g)
    r = torch.randn(16, 12, 128, generator=g)
    first = [t.clone() for t in _grads(moe.moe_mlp, cfg, p, x, r)]
    second = _grads(moe.moe_mlp, cfg, p, x, r)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
