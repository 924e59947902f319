"""The port's CUDA mel kernel on the card, against its plain PyTorch version.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_mel_gpu.py -q

Tolerance: the kernel and its plain version compute the same products in
another summation order, held to 1e-3 dB (chip_smoke.py's gate); through
the model, 1e-3 in probabilities (tests/test_pallas_mel.py:67).
"""

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.frontend import FrontendConfig
from uit_mobile_tpu_torch.ops import make_forward_fn
from uit_mobile_tpu_torch.ops import mel as mel_ops

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the mel kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pcm(B, T=16000, seed=8):
    wav = np.random.default_rng(seed).standard_normal((B, T)) * 0.1
    return np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("transposed", [False, True])
def test_cuda_kernel_matches_plain(cuda, precision, transposed):
    pcm = torch.from_numpy(_pcm(mel_ops.TFB_MIN_BATCH)).to(cuda)
    fe = FrontendConfig()
    wp_i = mel_ops.reflect_pad(pcm, 256).contiguous()
    wp_f = mel_ops.reflect_pad(pcm.float() / 32768.0, 256).contiguous()
    mats_i = mel_ops._matrices(fe, True, precision, cuda)
    mats_f = mel_ops._matrices(fe, False, precision, cuda)
    got = mel_ops.cuda_log_mel_rows(wp_i, mats_i, precision, fe.hop_length, transposed)
    want = mel_ops.plain_log_mel_rows(wp_i, mats_i, precision, fe.hop_length)
    if transposed:
        want = want.permute(1, 2, 0)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    # int16 input is bitwise the normalized float input
    assert torch.equal(got, mel_ops.cuda_log_mel_rows(wp_f, mats_f, precision,
                                                      fe.hop_length, transposed))
    if transposed:  # each row's arithmetic is the same in both layouts
        row = mel_ops.cuda_log_mel_rows(wp_i, mats_i, precision, fe.hop_length, False)
        assert torch.equal(got, row.permute(1, 2, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("B, variant", [(4, "row_fast"), (mel_ops.TFB_MIN_BATCH, "tfb_fast")])
def test_cuda_forward_launches_kernel_and_matches_cpu(cuda, B, variant):
    """make_forward_fn on the card goes through the kernel (the launch count
    moves) and agrees with the plain path on the CPU."""
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=102)
    gpu_model, cpu_model = (models.build(cfg, torch.Generator().manual_seed(0), device=d)
                            for d in ("cuda", "cpu"))
    pcm = _pcm(B, seed=9)
    before = mel_ops.launches[variant]
    got = make_forward_fn(cfg, gpu_model, precision="fast")(pcm).cpu()
    assert mel_ops.launches[variant] == before + 1
    want = make_forward_fn(cfg, cpu_model, use_kernel=True, precision="fast")(pcm)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
