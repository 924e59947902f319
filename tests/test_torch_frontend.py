"""Port frontend (uit_mobile_tpu_torch.frontend) vs the torch.stft goldens and
the JAX reference frontend; plus the port's import boundary (no jax, nothing
of uit_mobile_tpu)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu.frontend import FrontendConfig as JaxFrontendConfig
from uit_mobile_tpu.frontend import log_mel_spectrogram as jax_log_mel
from uit_mobile_tpu_torch.frontend import (FrontendConfig, log_mel_spectrogram,
                                           mel_filterbank, spectrogram)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "goldens" / "frontend_golden.npz"
CASES = ["gsc_sample", "rand_batch", "long_loud", "silence"]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_mel_filterbank_matches_golden(golden):
    fb = mel_filterbank(FrontendConfig())
    assert fb.shape == (257, 64)
    np.testing.assert_allclose(fb, golden["mel_fb"], atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_power_and_log_mel_match_goldens(golden, case):
    wav = torch.from_numpy(golden[f"{case}_wav"])
    power = spectrogram(wav, FrontendConfig()).numpy()
    np.testing.assert_allclose(power, golden[f"{case}_power"], atol=2e-4, rtol=1e-4)
    logmel = log_mel_spectrogram(wav, FrontendConfig()).numpy()
    ref = golden[f"{case}_logmel"]
    assert logmel.shape == ref.shape
    # same tolerances as tests/test_frontend.py (f32 FFT rounding at valleys)
    np.testing.assert_allclose(logmel, ref, atol=0.05)
    assert np.mean(np.abs(logmel - ref)) < 5e-3


@pytest.mark.parametrize("mode", ["torch", "per_sample"])
@pytest.mark.parametrize("shape", [(3, 16000), (2, 40000), (16000,)])
def test_matches_jax_frontend(mode, shape):
    """Same numpy input through both packages: <= 5e-4 dB (measured 3.1e-5)."""
    wav = (np.random.default_rng(0).standard_normal(shape) * 0.1).astype(np.float32)
    a = np.asarray(jax_log_mel(jnp.asarray(wav), JaxFrontendConfig(top_db_mode=mode)))
    b = log_mel_spectrogram(torch.from_numpy(wav), FrontendConfig(top_db_mode=mode)).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=5e-4, rtol=0)


def test_batch_global_top_db_couples_the_batch():
    """'torch' mode clamps a 3-D batch against one global max; 'per_sample'
    equals each clip run alone."""
    wav = np.zeros((2, 16000), np.float32)
    wav[0, 4000:4050] = 0.99
    wav[1] = np.random.default_rng(1).standard_normal(16000).astype(np.float32) * 1e-4
    t = torch.from_numpy(wav)
    glob = log_mel_spectrogram(t, FrontendConfig())
    per = log_mel_spectrogram(t, FrontendConfig(top_db_mode="per_sample"))
    assert torch.isclose(glob.min(), glob.max() - 120.0)
    for i in range(2):
        solo = log_mel_spectrogram(t[i:i + 1], FrontendConfig())
        torch.testing.assert_close(per[i], solo[0], atol=1e-5, rtol=0)


def test_int16_bitwise_equals_normalized_f32():
    rng = np.random.default_rng(2)
    pcm = rng.integers(-32768, 32767, size=(2, 16000), dtype=np.int16)
    a = log_mel_spectrogram(torch.from_numpy(pcm), FrontendConfig())
    b = log_mel_spectrogram(torch.from_numpy(pcm.astype(np.float32) / 32768.0),
                            FrontendConfig())
    assert torch.equal(a, b)


def test_too_short_raises():
    with pytest.raises(ValueError, match="too short"):
        log_mel_spectrogram(torch.zeros(1, 256), FrontendConfig())
    assert FrontendConfig().num_frames(16000) == 101


def _port_modules():
    pkg = REPO / "uit_mobile_tpu_torch"
    return sorted(
        "uit_mobile_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        .replace(".__init__", "").rstrip(".")
        for p in pkg.rglob("*.py"))


def test_port_imports_without_jax():
    """Every port module imports with jax and uit_mobile_tpu blocked."""
    mods = [m.rstrip(".") for m in _port_modules()]
    assert {f"uit_mobile_tpu_torch.evaluate.{m}" for m in
            ("harness", "calibration", "events", "psds", "metrics")} <= set(mods)
    assert "uit_mobile_tpu_torch.cli.evaluate" in mods
    assert {f"uit_mobile_tpu_torch.{m}" for m in
            ("serve.streaming", "serve.http", "cli.serve", "cli.stream", "cli.bench",
             "utils.flops", "utils.profiling")} <= set(mods)
    assert {f"uit_mobile_tpu_torch.{m}" for m in
            ("ckpt.torch_convert", "data.psl_cache", "cli.psl_cache", "train.sed",
             "train.pretrain")} <= set(mods)
    assert {f"uit_mobile_tpu_torch.{m}" for m in
            ("ckpt.artifact", "ckpt.dcp_io", "cli.export", "cli.average", "models.moe",
             "parallel.ep")} <= set(mods)
    assert {f"uit_mobile_tpu_torch.{m}" for m in
            ("parallel.mesh", "parallel.multihost", "parallel.rows", "parallel.fsdp",
             "cli.launch")} <= set(mods)
    assert {f"uit_mobile_tpu_torch.parallel.{m}" for m in
            ("tp", "sp", "pp", "ep", "fsdp", "collectives")} <= set(mods)
    assert {f"uit_mobile_tpu_torch.{m}" for m in
            ("data.prep", "cli.prep", "tools.gate_synthetic")} <= set(mods)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'uit_mobile_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'uit_mobile_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", ["uit_mobile_tpu_torch", "chip_smoke.py"])
def test_no_jax_imports_in_port_sources(path):
    import re

    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|jaxlib\b|uit_mobile_tpu\b(?!_torch))",
                     re.MULTILINE)
    bad = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert files and not bad, bad
