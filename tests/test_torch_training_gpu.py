"""The rest of training on the card: bfloat16 compute, PSL cache scoring,
the SED step and the MAE step, each against the same work on the CPU plain
path (the mel kernel's plain version, float32 convs and matmuls).

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax, nor the JAX package, nor h5py, pandas or PyYAML:

    python -m pytest --noconftest -m gpu tests/test_torch_training_gpu.py -q -s

Tolerances: the UiT's bfloat16 probabilities on the card within 2e-3 of the
CPU's bfloat16 and within 5e-3 of the CPU's float32 (the JAX package's
bfloat16 budget); the PSL cache (a teacher with calibrated BNs, whose
scores vary between crops) within 1e-3 plus float16 rounding (5e-4) of the
CPU's, and that teacher's bfloat16 probabilities on the card nearer the
CPU's bfloat16 than the CPU's bfloat16 is to its float32;
one SED step (SGD) loss 1e-4 relative and parameters 1e-5; one MAE forward
(the same noise) loss 1e-4 relative and every gradient within 1e-4 of the
CPU's relative to its tensor's largest. The readings are printed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import load_numpy
from uit_mobile_tpu_torch.cli.psl_cache import make_teacher_fn
from uit_mobile_tpu_torch.data.psl_cache import score_psl_cache
from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip
from uit_mobile_tpu_torch.models.mobilenetv2 import calibrate_bn
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step
from uit_mobile_tpu_torch.train import pretrain as mae
from uit_mobile_tpu_torch.train.steps import make_framewise_train_step

torch.set_num_threads(4)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the mel kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pcm(B, seconds=1.0, seed=0):
    wav = np.random.default_rng(seed).standard_normal((B, int(16000 * seconds))) * 0.1
    return np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)


def _both(cfg, init, fn):
    """fn(model, device) on the card and on the CPU, from the same weights."""
    return {name: fn(module_from_numpy(cfg, *init, device=name), torch.device(name))
            for name in ("cuda", "cpu")}


def test_bf16_forward_and_step(cuda):
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102, depth=2)
    init = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(1), "cpu"))
    pcm = _pcm(64)
    fe = make_frontend_fn(cfg.frontend, precision="fast")

    def forward(c):
        return lambda m, dev: models.apply(c, m, torch.from_numpy(pcm).to(dev),
                                           frontend_fn=fe).cpu()

    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    got, f32 = _both(bf16, init, forward(bf16)), _both(cfg, init, forward(cfg))
    vs_cpu = (got["cuda"] - got["cpu"]).abs().max().item()
    drift = (got["cuda"] - f32["cpu"]).abs().max().item()
    target = torch.zeros(64, 537)
    target[:, 527] = 1.0

    def step(m, dev):
        opt = build_optimizer("AdamW", 1e-3).init(m)
        out = make_train_step(bf16, m, opt, frontend_fn=fe)(
            {"wav": torch.from_numpy(pcm).to(dev), "target": target.to(dev)})
        return out["total_loss"].item()

    losses = _both(bf16, init, step)
    print({"bf16_vs_cpu_bf16": vs_cpu, "bf16_vs_cpu_f32": drift, "losses": losses})
    assert vs_cpu <= 2e-3 and 0 < drift <= 5e-3
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-3 * abs(losses["cpu"])


def test_teacher_bf16_and_psl_cache_scoring(cuda):
    f32 = models.get_model_config("MobileNetV2", outputdim=527)
    cfg = dataclasses.replace(f32, compute_dtype="bfloat16")
    rng = np.random.default_rng(2)
    clips = [(f"c{i}", synth_eventful_clip(rng, eventful_labels(rng), seconds=s))
             for i, s in enumerate((1.0, 1.7, 0.6, 2.5))]
    # BNs calibrated on eventful clips: at its init the teacher scores
    # sigmoid(bias) whatever the crop
    calib = np.stack([synth_eventful_clip(rng, eventful_labels(rng), seconds=1.0)
                      for _ in range(8)]).astype(np.float32) / 32768
    init = module_to_numpy(calibrate_bn(f32, models.build(f32, torch.Generator().manual_seed(2),
                                                          "cpu"), torch.from_numpy(calib)))
    fe = make_frontend_fn(f32.frontend, precision="exact")
    caches, probs = {}, {}
    for dev in ("cuda", "cpu"):
        teacher = module_from_numpy(f32, *init, device=dev)
        caches[dev] = score_psl_cache(clips, make_teacher_fn(f32, teacher), batch_size=8,
                                      teacher_name="mbv2")
        wav = torch.from_numpy(calib).to(dev)
        probs[dev] = {c.compute_dtype: models.apply(c, teacher, wav, frontend_fn=fe).cpu()
                      for c in (f32, cfg)}
    worst = max(np.abs(caches["cuda"][k].astype(np.float32)
                       - caches["cpu"][k].astype(np.float32)).max() for k, _ in clips)
    rows = [caches["cpu"][k].astype(np.float32) for k, _ in clips]
    spread = float(np.concatenate(rows).std(0).mean())
    grid_step = min(float(np.abs(np.diff(r, axis=0)).max(1).min()) for r in rows if len(r) > 1)
    g, c = probs["cuda"], probs["cpu"]
    bf16_vs_cpu = (g["bfloat16"] - c["bfloat16"]).abs().max().item()
    drift_card = (g["bfloat16"] - g["float32"]).abs().max().item()
    drift_cpu = (c["bfloat16"] - c["float32"]).abs().max().item()
    print({"psl_cache_max_abs_diff": float(worst), "rows": sum(len(r) for r in rows),
           "std_over_crops": spread, "min_grid_step_diff": grid_step,
           "bf16_vs_cpu_bf16": bf16_vs_cpu, "bf16_drift_card": drift_card,
           "bf16_drift_cpu": drift_cpu})
    # the scores depend on the crop, by more than the bound between grid steps
    assert spread > 5e-3 and grid_step > 1.5e-3
    assert caches["cuda"].attrs == caches["cpu"].attrs and worst <= 1.5e-3
    # bfloat16 engaged on the card, and nearer the CPU's bfloat16 than
    # bfloat16 is to float32 (a rounding that flips on either side moves
    # this teacher by up to ~3e-3)
    assert drift_card > 0 and bf16_vs_cpu <= drift_cpu


def test_sed_step(cuda):
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102, depth=2,
                                  pooling="dm")
    init = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(4), "cpu"))
    pcm = _pcm(64, seed=5)
    target = torch.from_numpy((np.random.default_rng(6).random((64, 6, 537)) < 0.05)
                              .astype(np.float32))
    fe = make_frontend_fn(cfg.frontend, precision="exact")

    def step(m, dev):
        opt = build_optimizer("SGD", 0.1).init(m)
        out = make_framewise_train_step(cfg, m, opt, max_grad_norm=1.0, frontend_fn=fe)(
            {"wav": torch.from_numpy(pcm).to(dev), "target": target.to(dev)})
        return out["total_loss"].item(), {k: v.detach().cpu()
                                          for k, v in m.named_parameters()}

    runs = _both(cfg, init, step)
    (l_g, p_g), (l_c, p_c) = runs["cuda"], runs["cpu"]
    worst = max((p_g[k] - p_c[k]).abs().max().item() for k in p_c)
    print({"sed_loss_gpu": l_g, "sed_loss_cpu": l_c, "params_max_abs_diff": worst})
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c) and worst <= 1e-5


def test_mae_step(cuda):
    enc = models.get_model_config("uit_xs", outputdim=527, target_length=1012, depth=2)
    cfg = mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=2)
    params, state = module_to_numpy(mae.init(cfg, torch.Generator().manual_seed(7)))
    wav = torch.from_numpy(_pcm(8, 10.12, seed=8).astype(np.float32) / 32768.0)
    noise = torch.rand((8, cfg.num_patches), generator=torch.Generator().manual_seed(9))
    runs = {}
    for dev in ("cuda", "cpu"):
        model = load_numpy(mae.MAE(cfg), params, state).to(dev)
        loss, _, _ = mae.forward(cfg, model, wav.to(dev), noise=noise.to(dev))
        grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
        runs[dev] = (loss.item(), [g.cpu() for g in grads])
    (l_g, g_g), (l_c, g_c) = runs["cuda"], runs["cpu"]
    rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
              for a, b in zip(g_g, g_c))
    print({"mae_loss_gpu": l_g, "mae_loss_cpu": l_c, "max_grad_rel_diff": rel})
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c) and rel <= 1e-4
