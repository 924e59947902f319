"""What the drivers share: the program's model built from a configuration
file and the benchmark's weights, the gaps of two sets of norms, and the
cell's sizes with a test's small ones in their place."""

from __future__ import annotations

import statistics

import torch


def sizes(ctx, keys: dict) -> dict:
    """The traffic file's values of ``keys`` (name -> default), with the
    test's ``small`` sizes in their place where given."""
    tr = ctx.cell.traffic
    out = {k: tr.get(k, d) for k, d in keys.items()}
    out.update({k: v for k, v in (ctx.small or {}).items() if k in keys})
    return out


def model_config(ctx) -> dict:
    """The configuration file as run (a test's ``small`` may set ``depth``)."""
    cfg = dict(ctx.cell.config)
    if ctx.small and "depth" in ctx.small:
        cfg["depth"] = ctx.small["depth"]
    return cfg


def program_config(cfg: dict):
    """The program's config object of a configuration file: its factory
    with the file's head, window and depth, every other size checked
    against the file (a mismatch raises: the file is what runs)."""
    from uit_mobile_tpu_torch import models

    kw = dict(outputdim=cfg["outputdim"], target_length=cfg["target_length"],
              depth=cfg["depth"])
    pcfg = models.get_model_config(cfg["factory"], **kw)
    base = getattr(pcfg, "base", pcfg)
    fe = base.frontend
    have = {"embed_dim": base.embed_dim, "depth": base.depth, "num_heads": base.num_heads,
            "mlp_ratio": base.mlp_ratio, "attention": base.attention_type, "act": base.act,
            "pooling": base.pooling, "patch_size": base.patch_size, "n_mels": base.n_mels,
            "init_bn": base.init_bn, "qkv_bias": base.qkv_bias,
            "compute_dtype": base.compute_dtype,
            "frontend": {"sample_rate": fe.sample_rate, "n_fft": fe.n_fft,
                         "win_length": fe.win_length, "hop_length": fe.hop_length,
                         "n_mels": fe.n_mels, "f_min": fe.f_min, "f_max": fe.f_max,
                         "top_db": fe.top_db}}
    if "moe" in cfg:
        have["moe"] = {"n_experts": pcfg.n_experts, "top_k": pcfg.top_k,
                       "capacity_factor": pcfg.capacity_factor,
                       "router_aux_weight": pcfg.router_aux_weight}
    for key, value in have.items():
        if cfg[key] != value:
            raise ValueError(f"configuration {cfg['name']}: {key} is {cfg[key]!r} in its "
                             f"file but {value!r} in the program's {cfg['factory']}")
    if base.drop_rate or base.attn_drop_rate or base.drop_path_rate:
        raise ValueError("the benchmark's configurations run without dropout")
    return pcfg


def build_model(pcfg, weights: dict, device, train: bool = False):
    """The program's parameter container on ``device``, holding ``weights``."""
    from uit_mobile_tpu_torch import models

    model = models.module_class(pcfg)(pcfg).to(device)
    with torch.no_grad():
        model.load_state_dict(weights, strict=True)
    return model.train(train)


def leaf_gaps(names, program: list, reference: list) -> dict:
    """{leaf: |a - b| / max(b, the median leaf's b)} of two sets of norms
    (the program's, the reference's)."""
    floor = statistics.median(reference)
    return {n: abs(a - b) / max(b, floor) for n, a, b in zip(names, program, reference)}
