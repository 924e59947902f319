"""The port's TaggingService on the CPU (device="cpu") with uit_xxxs."""

import threading

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops import make_forward_fn
from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=2)
    return cfg, models.build(cfg, torch.Generator().manual_seed(0), device="cpu")


def _clips(seed):
    rng = np.random.default_rng(seed)
    return ([(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (16000, 12000, 16000)]
            + [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (48000, 40000)])


def _direct(cfg, model, wav, dtype, **fwd_kwargs):
    """Per-clip forward on the clip zero-padded to its bucket."""
    length = -(-len(wav) // 16000) * 16000
    x = np.zeros((1, length), np.float32)
    x[0, :len(wav)] = wav
    if dtype == "int16":
        x = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
    return make_forward_fn(cfg, model, top_db_mode="per_sample", **fwd_kwargs)(x)[0].numpy()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_results_equal_direct_forward(model, dtype):
    cfg, m = model
    wavs = _clips(0)
    with TaggingService(cfg, m, ServiceConfig(batch_size=4, max_seconds=3, warmup=False,
                                              dtype=dtype), device="cpu") as svc:
        got = svc.infer_many(wavs)
    for w, g in zip(wavs, got):
        assert g.shape == (537,) and ((g >= 0) & (g <= 1)).all()
        np.testing.assert_allclose(g, _direct(cfg, m, w, dtype), atol=1e-5, rtol=0)


def test_low_latency_on_the_kernel_route(model):
    """low_latency() (8-clip bucket, int16) with the kernel route forced: on
    the CPU the service runs the fast kernel's plain version in 'tfb'."""
    cfg, m = model
    conf = ServiceConfig.low_latency(max_seconds=3, warmup=False, use_kernel=True)
    assert (conf.batch_size, conf.max_wait_ms, conf.scan_batches, conf.dtype) == (
        8, 0.0, 1, "int16")
    wavs = _clips(4)
    with TaggingService(cfg, m, conf, device="cpu") as svc:
        got = svc.infer_many(wavs)
    for w, g in zip(wavs, got):
        want = _direct(cfg, m, w, "int16", use_kernel=True, precision="fast")
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=0)


def test_scan_batches_equals_per_batch(model):
    cfg, m = model
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(8)]

    def run(scan):
        svc = TaggingService(cfg, m, ServiceConfig(batch_size=2, max_seconds=1, warmup=False,
                                                   scan_batches=scan),
                             device="cpu", _start_worker=False)
        futs = [svc.submit(w) for w in wavs]  # all queued before the worker starts
        svc._start()
        out = [f.result(timeout=60) for f in futs]
        svc.close()
        return np.stack(out)

    np.testing.assert_allclose(run(2), run(1), atol=1e-6, rtol=0)


def test_close_resolves_everything_and_rejects_after(model):
    cfg, m = model
    svc = TaggingService(cfg, m, ServiceConfig(batch_size=2, max_seconds=3, warmup=True),
                         device="cpu")
    futs = [svc.submit(w) for w in _clips(2)[:4]]
    svc.close()
    assert all(f.done() and f.result().shape == (537,) for f in futs)
    assert not svc._worker.is_alive() and not svc._completer.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros(16000, np.float32))


def test_submit_validation_and_reload(model):
    cfg, m = model
    with TaggingService(cfg, m, ServiceConfig(batch_size=2, max_seconds=1, warmup=False),
                        device="cpu") as svc:
        with pytest.raises(ValueError, match="max_seconds"):
            svc.submit(np.zeros(32000, np.float32))
        with pytest.raises(ValueError, match="mono"):
            svc.submit(np.zeros((2, 8000), np.float32))
        before = svc.submit(np.zeros((1, 8000), np.float32)).result(timeout=60)
        m2 = models.build(cfg, torch.Generator().manual_seed(5), device="cpu")
        assert svc.reload(m2) == 2
        after = svc.submit(np.zeros((1, 8000), np.float32)).result(timeout=60)
        assert not np.allclose(before, after)


def test_concurrent_submitters(model):
    """Many threads submitting at once: every Future resolves to its own clip."""
    cfg, m = model
    rng = np.random.default_rng(3)
    wavs = [(rng.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(12)]
    results = [None] * len(wavs)
    with TaggingService(cfg, m, ServiceConfig(batch_size=4, max_seconds=1, warmup=False,
                                              max_wait_ms=1.0), device="cpu") as svc:
        def worker(i):
            results[i] = svc.submit(wavs[i]).result(timeout=60)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    want = make_forward_fn(cfg, m, top_db_mode="per_sample")(np.stack(wavs)).numpy()
    np.testing.assert_allclose(np.stack(results), want, atol=1e-5, rtol=0)


def test_device_defaults_to_cuda(model):
    cfg, m = model
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TaggingService(cfg, m, ServiceConfig(warmup=False))
    # calibration is served now; data-parallel serving is still to port
    with TaggingService(cfg, m, ServiceConfig(warmup=False), device="cpu",
                        calibration=1.5) as svc:
        assert svc.calibration == 1.5
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TaggingService(cfg, m, ServiceConfig(warmup=False, data_parallel=True), device="cpu")
