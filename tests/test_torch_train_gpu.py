"""The port's train step on the card: the fused mel kernel runs forward in
the student and the PSL teacher, against the plain path on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py -q

Tolerances: one train step on the card against the same step through the
kernel's plain version on the CPU, loss 1e-4 relative, pre-clip gradient
norm 1e-3 relative, every gradient within 1e-4 of the CPU's relative to
its tensor's largest, updated parameters max |diff| 1e-5 outside the
elements whose gradient is below 1e-7, counted (Adam's first step is +-lr
there whatever the sign of a rounding; the mel kernel sits within 1e-3 dB
plus a few float32 roundings of its plain version, ops/mel.py:tolerance_db).
The readings are printed (``-s`` shows them). 'tfb_to_bft' on the card is bitwise the row
kernel: through the transposed kernel at fast precision and B >= 128, as
in the JAX package, else the row kernel itself.
"""

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.ops import mel as mel_ops
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the mel kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pcm(B, seed):
    wav = np.random.default_rng(seed).standard_normal((B, 16000)) * 0.1
    return np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)


def _step_on(device, cfg, p_np, s_np, teacher, batch, layout):
    model = module_from_numpy(cfg, p_np, s_np, device=device)
    t_cfg, t_p, t_s = teacher
    t_model = module_from_numpy(t_cfg, t_p, t_s, device=device).requires_grad_(False)
    opt = build_optimizer("AdamW", 1e-3, weight_decay=5e-8).init(model)
    step = make_train_step(
        cfg, model, opt, max_grad_norm=1.0, psl_cfg=t_cfg, psl_model=t_model,
        psl_split=batch["wav"].shape[0] // 2, distill_classes=10,
        frontend_fn=make_frontend_fn(cfg.frontend, precision="exact", layout=layout),
        psl_frontend_fn=make_frontend_fn(t_cfg.frontend, precision="exact",
                                         layout="tfb_to_bft"))
    m = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
             torch.Generator(device=device).manual_seed(0))
    # after one update the first moment is (1 - b1) x the step's gradient
    grads = {n: (mu / 0.1).cpu() for n, mu in zip(opt.names, opt.moments[0])}
    return m, model, t_model, grads


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bft", "tfb"])
def test_train_step_on_card_matches_cpu_plain_path(cuda, layout):
    cfg = models.get_model_config("uit_xxxs", outputdim=21, target_length=102, depth=2,
                                  mel_layout=layout)
    p_np, s_np = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(0), "cpu"))
    t_cfg = models.get_model_config("MobileNetV2", outputdim=17)
    teacher = (t_cfg, *module_to_numpy(models.build(t_cfg, torch.Generator().manual_seed(1),
                                                    "cpu")))
    batch = {"wav": _pcm(8, 3),
             "target": (np.random.default_rng(4).uniform(size=(8, 21)) > 0.7).astype(np.float32)}
    before = dict(mel_ops.launches)
    m_gpu, gpu_model, t_model, grads_gpu = _step_on(cuda, cfg, p_np, s_np, teacher, batch,
                                                    layout)
    launched = {k: mel_ops.launches[k] - before[k] for k in before}
    # the student's and the teacher's mel, both on the row kernel below B=128
    assert launched == {"row_exact": 2, "row_fast": 0, "tfb_exact": 0, "tfb_fast": 0}
    m_cpu, cpu_model, _, grads = _step_on("cpu", cfg, p_np, s_np, teacher, batch, layout)
    assert m_gpu["total_loss"].item() == pytest.approx(m_cpu["total_loss"].item(), rel=1e-4)
    assert m_gpu["grad_norm"].item() == pytest.approx(m_cpu["grad_norm"].item(), rel=1e-3)
    grad_rel = max(((grads_gpu[k] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                   for k, g in grads.items())
    # elements whose gradient is below 1e-7 are left out and counted: Adam's
    # first step is +-lr there, whatever the sign of a rounding
    excluded, worst, worst_all = 0, 0.0, 0.0
    for (k, a), b in zip(gpu_model.state_dict().items(), cpu_model.state_dict().values()):
        g = grads.get(k)
        keep = (torch.ones_like(b, dtype=torch.bool) if g is None
                else (g.abs() >= 1e-7) | (g == 0))
        excluded += int((~keep).sum())
        d = (a.cpu() - b).abs()
        worst, worst_all = max(worst, d[keep].max().item()), max(worst_all, d.max().item())
    total = sum(v.numel() for v in cpu_model.parameters())
    print(f"\n{layout}: grad rel diff {grad_rel:.3g}, params max |diff| {worst:.3g} "
          f"({worst_all:.3g} over all elements), {excluded} of {total} elements excluded")
    assert grad_rel <= 1e-4
    assert worst <= 1e-5
    assert excluded < total // 20
    # the teacher never moves
    after, start = flatten_tree(module_to_numpy(t_model)[1], "."), flatten_tree(teacher[2], ".")
    assert after.keys() == start.keys()
    assert all(np.array_equal(after[k], start[k]) for k in start)


@pytest.mark.gpu
@pytest.mark.parametrize("precision, B, variant", [
    ("fast", mel_ops.TFB_MIN_BATCH, "tfb_fast"), ("fast", 300, "tfb_fast"),
    ("fast", 16, "row_fast"), ("exact", 256, "row_exact"), ("exact", 16, "row_exact")])
def test_tfb_to_bft_on_card_is_bitwise_the_row_kernel(cuda, precision, B, variant):
    wav = torch.from_numpy(_pcm(B, 5)).to(cuda)
    before = dict(mel_ops.launches)
    got = make_frontend_fn(precision=precision, layout="tfb_to_bft")(wav)
    assert mel_ops.launches[variant] == before[variant] + 1
    want = make_frontend_fn(precision=precision, layout="bft")(wav)
    assert got.shape == want.shape == (B, 64, 101)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_moe_forward_on_the_card_matches_cpu(cuda):
    """The MoE UiT served on the card (the exact row kernel through
    'tfb_to_bft') within 1e-3 of the CPU plain path."""
    from uit_mobile_tpu_torch.ops import make_forward_fn

    cfg = models.get_model_config("uit_xs_moe", outputdim=537, target_length=1012, depth=2)
    gpu_model, cpu_model = (models.build(cfg, torch.Generator().manual_seed(5), device=d)
                            for d in ("cuda", "cpu"))
    pcm = np.random.default_rng(13).integers(-3000, 3000, (4, 160000), dtype=np.int16)
    before = mel_ops.launches["row_exact"]
    got = make_forward_fn(cfg, gpu_model, precision="exact")(pcm).cpu()
    assert mel_ops.launches["row_exact"] == before + 1
    want = make_forward_fn(cfg, cpu_model, use_kernel=True, precision="exact")(pcm)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
