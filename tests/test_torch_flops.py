"""The port's FLOP accounting (utils/flops.py): the hand model equal to the
JAX package's, term by term, for uit_xs/xxs/xxxs at 1 s and 10 s;
FlopCounterMode on the CPU plain forward through the kernel's plain version
(the DFT as a GEMM) within 0.85-1.3x of the hand model, the band JAX's
tests/test_flops.py allows its cost analysis; the NVIDIA peak tables."""

import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.utils import flops as jax_flops
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops import make_forward_fn
from uit_mobile_tpu_torch.utils import flops

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["uit_xs", "uit_xxs", "uit_xxxs"])
@pytest.mark.parametrize("n_samples", [16000, 160000])
def test_hand_model_equals_jax(name, n_samples):
    kw = dict(outputdim=537, target_length=102)
    cfg, jcfg = models.get_model_config(name, **kw), jax_models.get_model_config(name, **kw)
    assert flops.frontend_flops(cfg.frontend, n_samples) == jax_flops.frontend_flops(
        jcfg.frontend, n_samples)
    assert flops.uit_encoder_flops(cfg) == jax_flops.uit_encoder_flops(jcfg)
    assert flops.uit_forward_flops(cfg, n_samples) == jax_flops.uit_forward_flops(
        jcfg, n_samples)
    for dtype in ("int16", "float32"):
        assert flops.uit_serve_stage_bytes(cfg, 256, n_samples, dtype) == \
            jax_flops.uit_serve_stage_bytes(jcfg, 256, n_samples, dtype)


def test_hand_model_magnitudes_uit_xs():
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
    fe = flops.frontend_flops(cfg.frontend, 16000)
    total = flops.uit_forward_flops(cfg, 16000)
    assert 55e6 < fe < 65e6 and 60e6 < flops.uit_encoder_flops(cfg) < 75e6
    assert 115e6 < total < 145e6
    assert 9 < flops.uit_forward_flops(cfg, 160000) / total < 11
    assert flops.train_step_flops(100.0) == 300.0


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_counted_flops_close_to_hand_model(precision):
    """The plain forward with the kernel's plain version runs the DFT and the
    filterbank as matmuls, which FlopCounterMode counts. The fast DFT is
    three bf16-split products, counted three times: two of them are taken
    off before the comparison (the hand model counts the logical DFT once)."""
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
    model = models.build(cfg, torch.Generator().manual_seed(0), device="cpu")
    B = 2
    fwd = make_forward_fn(cfg, model, use_kernel=True, precision=precision)
    got = flops.counted_flops(fwd, torch.zeros(B, 16000))
    fe = cfg.frontend
    dft = 2.0 * fe.num_frames(16000) * fe.n_fft * fe.n_fft
    got -= B * 2 * dft if precision == "fast" else 0.0
    want = B * flops.uit_forward_flops(cfg, 16000)
    assert 0.85 < got / want < 1.3, (got, want)


def test_peak_tables_and_mfu():
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert flops.device_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert flops.mfu(98.9e12, "NVIDIA H100 80GB HBM3") == pytest.approx(0.1)
    assert flops.hbm_util(0.335e12, "NVIDIA H100 80GB HBM3") == pytest.approx(0.1)
    for unknown in ("TPU v5 lite", "Colossus MK3"):
        assert flops.device_peak_flops(unknown) is None
        assert flops.mfu(1.0, unknown) is None and flops.hbm_util(1.0, unknown) is None
    if not torch.cuda.is_available():  # no card: the current device is unknown
        assert flops.device_peak_flops() is None
    assert all(not k.startswith("TPU") for k in flops.PEAK_BF16_FLOPS)
    assert np.isfinite(list(flops.HBM_BANDWIDTH.values())).all()
