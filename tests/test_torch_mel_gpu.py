"""The port's CUDA mel kernel on the card, against its plain PyTorch version.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_mel_gpu.py -q

Tolerance: the kernel and its plain version compute the same products in
another summation order, held to 1e-3 dB, plus, on noise seeded by the
shape, a few float32 roundings of each DFT sum where it cancels
(ops/mel.py:tolerance_db, chip_smoke.py's gate); through the model, 1e-3 in
probabilities (tests/test_pallas_mel.py:67). int16 input must give bitwise
the output of f32/32768 input, and the transposed layout bitwise the row
layout transposed.
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
@pytest.mark.parametrize("B, variant", [(4, "row_fast"), (mel_ops.TFB_MIN_BATCH, "tfb_fast"),
                                        (4, "row_exact"), (mel_ops.TFB_MIN_BATCH, "tfb_exact")])
def test_cuda_forward_launches_kernel_and_matches_cpu(cuda, B, variant):
    """make_forward_fn on the card goes through the kernel (the launch count
    moves) and agrees with the plain path on the CPU."""
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=102)
    gpu_model, cpu_model = (models.build(cfg, torch.Generator().manual_seed(0), device=d)
                            for d in ("cuda", "cpu"))
    pcm = _pcm(B, seed=9)
    precision = variant.split("_")[1]
    before = mel_ops.launches[variant]
    got = make_forward_fn(cfg, gpu_model, precision=precision)(pcm).cpu()
    assert mel_ops.launches[variant] == before + 1
    want = make_forward_fn(cfg, cpu_model, use_kernel=True, precision=precision)(pcm)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def _check_variants(cuda, B, T, hop, precision):
    """Both layouts of one precision, both input types, on noise seeded by
    the shape. Against the plain version the kernel is held to
    tolerance_db: 1e-3 dB plus a few float32 roundings of each DFT sum,
    since where a DFT value cancels (mel 0 of frame 0 at B=257, T=48000:
    -72.5 dB) two summation orders differ by more than 1e-3 dB (the fast
    kernel 6.98e-3 dB from plain)."""
    fe = FrontendConfig()
    pcm = torch.from_numpy(_pcm(B, T, seed=B + T)).to(cuda)
    wp_i = mel_ops.reflect_pad(pcm, 256).contiguous()
    wp_f = mel_ops.reflect_pad(pcm.float() / 32768.0, 256).contiguous()
    mats_i = mel_ops._matrices(fe, True, precision, cuda)
    mats_f = mel_ops._matrices(fe, False, precision, cuda)
    want = mel_ops.plain_log_mel_rows(wp_f, mats_f, precision, hop)
    row = mel_ops.cuda_log_mel_rows(wp_f, mats_f, precision, hop, False)
    assert ((row - want).abs() <= mel_ops.tolerance_db(wp_f, mats_f, hop, precision)).all()
    assert torch.equal(row, mel_ops.cuda_log_mel_rows(wp_i, mats_i, precision, hop, False))
    tfb = mel_ops.cuda_log_mel_rows(wp_i, mats_i, precision, hop, True)
    assert torch.equal(tfb, row.permute(1, 2, 0))
    assert torch.equal(tfb, mel_ops.cuda_log_mel_rows(wp_f, mats_f, precision, hop, True))
    # a clip's rows do not depend on where the batch puts them in a tile
    head = (B + 1) // 2
    assert torch.equal(row[:head], mel_ops.cuda_log_mel_rows(wp_f[:head], mats_f, precision, hop,
                                                             False))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16000, 16001, 48000])
@pytest.mark.parametrize("B", [1, 63, 65, 127, 129, 257])
def test_fast_kernel_ragged_tiles_and_lengths(cuda, B, T):
    """Batches around the kernel's 128-row tile (and its 64-row warpgroup
    halves), row tiles that straddle clips, and T=16001, whose padded rows
    are not a multiple of 16 bytes long."""
    _check_variants(cuda, B, T, 160, "fast")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16000, 16001, 48000])
@pytest.mark.parametrize("B", [1, 63, 65, 127, 129, 257])
def test_exact_kernel_ragged_tiles_and_lengths(cuda, B, T):
    """The exact kernel (6 DFT passes, 16-deep ring stages) at the same
    shapes."""
    _check_variants(cuda, B, T, 160, "exact")


@pytest.mark.gpu
def test_fast_kernel_hop_not_a_multiple_of_8(cuda):
    """hop=157: frame starts fall off 16-byte alignment, so the kernel's
    producer takes its scalar-load path for most rows."""
    _check_variants(cuda, 65, 16001, 157, "fast")


@pytest.mark.gpu
def test_exact_kernel_hop_not_a_multiple_of_8(cuda):
    _check_variants(cuda, 65, 16001, 157, "exact")


@pytest.mark.gpu
@pytest.mark.parametrize("B, variant", [(4, "row_fast"), (mel_ops.TFB_MIN_BATCH, "tfb_fast"),
                                        (4, "row_exact"), (mel_ops.TFB_MIN_BATCH, "tfb_exact")])
def test_eager_log_mel_through_the_op_is_the_ctypes_launch(cuda, B, variant):
    """log_mel calls the kernel through the custom op
    (uit_mobile_tpu_torch::log_mel_rows): bitwise the direct ctypes launch,
    counted once per call."""
    layout, precision = variant.split("_")
    fe = FrontendConfig()
    pcm = torch.from_numpy(_pcm(B, seed=11)).to(cuda)
    before = mel_ops.launches[variant]
    got = mel_ops.log_mel(pcm, fe, precision=precision, layout="tfb" if layout == "tfb" else "btf")
    assert mel_ops.launches[variant] == before + 1
    wp = mel_ops.reflect_pad(pcm, fe.n_fft // 2).contiguous()
    mats = mel_ops._matrices(fe, True, precision, cuda)
    raw = mel_ops.cuda_log_mel_rows(wp, mats, precision, fe.hop_length, layout == "tfb")
    assert fe.top_db_mode == "torch"  # the batch-global clamp
    assert torch.equal(got, torch.maximum(raw, raw.max() - fe.top_db))
