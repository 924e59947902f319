"""``counts/flops.py`` against the program's ``utils/flops.py`` where both
count the same thing, and the routed experts against PyTorch's own count
of the reference's products."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import gen  # noqa: E402
from bench_port.counts import flops  # noqa: E402
from bench_port.reference import uit as ref  # noqa: E402

MOE = json.loads((ROOT / "bench_port/configs/uit_xs_moe.json").read_text())
# the dense UiT-XS that the MoE variant routes, at its published 102-frame
# window: what the program's hand model counts
CFG = dict(MOE, factory="uit_xs", moe=None, target_length=102)


def _program(cfg):
    from uit_mobile_tpu_torch import models

    return models.get_model_config(cfg["factory"], outputdim=cfg["outputdim"],
                                   target_length=cfg["target_length"])


@pytest.mark.parametrize("tokens", [12, 24, 248])
def test_encoder_matches_the_program_hand_model(tokens):
    from uit_mobile_tpu_torch.utils.flops import uit_encoder_flops

    assert flops.encoder_flops(CFG, tokens) == uit_encoder_flops(_program(CFG), tokens)


def test_one_second_window_matches_the_program_hand_model():
    """A 1 s clip: embed, encoder and head as the program counts them; the
    DFT and power as it counts them; the filterbank over the 257 bins (the
    program's hand model counts all 512 lanes of the packed basis)."""
    from uit_mobile_tpu_torch.utils.flops import frontend_flops, uit_forward_flops

    pcfg = _program(CFG)
    fe = pcfg.frontend
    n = flops.frames(CFG["frontend"], 16000)
    assert n == fe.num_frames(16000) == 101
    model_part = flops.forward_flops(CFG, 16000) - flops.mel_flops(CFG["frontend"], 16000)
    assert model_part == uit_forward_flops(pcfg, 16000) - frontend_flops(fe, 16000)
    fb_program = 2.0 * n * 512 * 64
    fb_here = 2.0 * n * 257 * 64
    assert flops.mel_flops(CFG["frontend"], 16000) == frontend_flops(fe, 16000) - fb_program + fb_here


def test_long_clip_counts_its_windows():
    one = flops.window_flops(CFG, 102)
    mel = flops.mel_flops(CFG["frontend"], 160000)
    assert flops.forward_flops(CFG, 160000) == mel + 10 * one  # 1001 frames: 10 windows


def test_routed_experts_count_top_k_products():
    """FlopCounterMode over the reference's routed MLP, with no token past
    the capacity: the router plus top_k expert MLPs a token."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dict(MOE, depth=1)
    W = gen.weights(ref.param_specs(cfg), 3, torch.device("cpu"))
    h = torch.randn(8, 24, cfg["embed_dim"], generator=torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter:
        ref.routed_mlp(cfg, W, "blocks.0", h)
    D, H, E = cfg["embed_dim"], int(cfg["embed_dim"] * cfg["mlp_ratio"]), 8
    N = h.shape[0] * h.shape[1]
    want = 2.0 * N * D * E + cfg["moe"]["top_k"] * 2.0 * N * D * H * 2
    assert counter.get_total_flops() == want
    per_block = flops.encoder_flops(cfg, 24) - flops.encoder_flops(dict(cfg, moe=None), 24)
    dense = 2.0 * 24 * D * H * 2
    assert per_block * 8 == want - 8 * dense


def test_train_step_is_the_mel_and_three_model_passes():
    B, n = 4, 160000
    mel = B * flops.mel_flops(MOE["frontend"], n)
    model = B * flops.window_flops(MOE, flops.frames(MOE["frontend"], n))
    assert flops.train_step_flops(MOE, B, n) == pytest.approx(mel + 3 * model)


def test_mel_bound_is_the_larger_bound():
    fe = CFG["frontend"]
    ops = 32 * flops.mel_flops(fe, 160000) / flops.PEAK_FLOPS
    by = 32 * flops.mel_bytes(fe, 160000) / flops.PEAK_BYTES
    assert flops.mel_bound_s(fe, 32, 160000) == max(ops, by) == ops
