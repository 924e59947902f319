"""The port's serving layer on the card: streaming (the device ring of
``feed_all``) at S=256 streams (``tfb_fast``) and S=16 (``row_fast``), one
POST /tag and one POST /events round trip through ``make_http_server``,
each against the CPU plain path (the kernel's plain version at the same
precision) within 1e-3 in probabilities, the JAX budget through the model
(tests/test_pallas_mel.py:67).

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py -q -s
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops import launches, make_forward_fn
from uit_mobile_tpu_torch.serve import (MultiStreamTagger, ServiceConfig, StreamingConfig,
                                        TaggingService, make_framewise_fn, make_http_server)

torch.set_num_threads(4)
TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the mel kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    cfg = models.get_model_config("uit_xxs", outputdim=537, target_length=102)
    return cfg, models.build(cfg, torch.Generator().manual_seed(3), device="cpu")


def _reset():
    for k in launches:
        launches[k] = 0


@pytest.mark.gpu
@pytest.mark.parametrize("S, variant", [(256, "tfb_fast"), (16, "row_fast")])
def test_streaming_on_the_card(cuda, model, S, variant):
    cfg, m = model
    sc = StreamingConfig(hop_seconds=0.25, dtype="int16")
    tagger = MultiStreamTagger(cfg, m, n_streams=S, config=sc, device="cuda")
    hop = 4000
    audio = (np.random.default_rng(S).standard_normal((S, 10 * hop)) * 3000).astype(np.int16)
    _reset()
    events = []
    for i in range(10):
        events += tagger.feed_all(audio[:, i * hop:(i + 1) * hop])
    counts = dict(launches)
    assert counts[variant] == 7 and sum(counts.values()) == 7, counts  # 7 scored hops
    assert tagger._host_stale and len(events) == 7 * S
    plain = make_forward_fn(cfg, m, use_kernel=True, precision="fast",
                            top_db_mode="per_sample")
    want = plain(audio[:, 6 * hop:10 * hop]).numpy()
    got = np.stack([e.probs for e in events[-S:]])
    drift = float(np.abs(got - want).max())
    print(f"stream S={S}: {variant} x{counts[variant]}, drift vs CPU plain {drift:.2e}")
    assert drift <= TOL


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read().decode())


@pytest.mark.gpu
def test_tag_and_events_round_trip_on_the_card(cuda, model):
    cfg, m = model
    svc = TaggingService(cfg, m, ServiceConfig(batch_size=32, max_seconds=3, dtype="int16"),
                         device="cuda")
    fw = make_framewise_fn(cfg, m, max_seconds=3, device="cuda")
    server = make_http_server(svc, port=0, framewise_fn=fw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        pcm = (np.random.default_rng(0).standard_normal(40000) * 3000).astype("<i2")
        _reset()
        tag = _post(base + "/tag?format=pcm16&full=1", pcm.tobytes())
        ev = _post(base + "/events?format=pcm16&threshold=0.5", pcm.tobytes())
        counts = dict(launches)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    assert counts["row_fast"] >= 1 and counts["row_exact"] == 1, counts
    padded = np.zeros((1, 48000), np.int16)
    padded[0, :40000] = pcm
    want = make_forward_fn(cfg, m, use_kernel=True, precision="fast",
                           top_db_mode="per_sample")(padded)[0].numpy()
    assert np.abs(np.asarray(tag["probs"]) - want).max() <= TOL
    cpu_fw = make_framewise_fn(cfg, m, max_seconds=3, use_kernel=True, device="cpu")
    probs, _ = cpu_fw(pcm.astype(np.float32) / 32768.0)
    card_probs, _ = fw(pcm.astype(np.float32) / 32768.0)
    assert np.abs(card_probs - probs).max() <= TOL
    assert ev["duration"] == 2.5 and isinstance(ev["events"], list)


@pytest.mark.gpu
def test_kernel_artifact_on_the_card_counts_its_launches(cuda, model, tmp_path):
    """An artifact exported with the kernel at a fixed batch, reloaded from
    its file: each call launches the kernel once (the op's CUDA
    implementation counts it) and agrees with make_forward_fn on the card."""
    from uit_mobile_tpu_torch.ckpt.artifact import export_serving, load_artifact, save_artifact

    cfg, cpu_model = model
    pcm = np.random.default_rng(12).integers(-3000, 3000, (4, 16000), dtype=np.int16)
    path = save_artifact(tmp_path / "k.uitx", export_serving(
        cfg, cpu_model, batch_size=4, dtype="int16", precision="fast", use_kernel=True,
        device="cuda"), cfg=cfg)
    fn, meta = load_artifact(path)
    assert meta["device"] == "cuda" and meta["use_kernel"]
    _reset()
    got = fn(pcm)
    assert launches["row_fast"] == 1 and sum(launches.values()) == 1
    want = make_forward_fn(cfg, cpu_model.to(cuda), precision="fast",
                           top_db_mode="per_sample")(pcm)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
