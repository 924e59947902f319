"""The port's HTTP front (serve/http.py) on the CPU against the JAX
package's: both servers on port 0 in threads, over the same weights
(carried through numpy), the same requests to both. Both services run the
exact plain frontend on the CPU: probabilities within 1e-5, top-k indices
equal (no ties at that size here), /events onsets and offsets equal, JSON
keys and status codes equal (the port's /healthz adds the card's name under
"device"). Also the port's calibrated TaggingService (scalar, (C,) vector,
calibration JSON) and its refusals."""

import http.client
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu import serve as jax_serve
from uit_mobile_tpu_torch import models, serve
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.data import write_wav
from uit_mobile_tpu_torch.evaluate.calibration import apply_temperature, save_calibration

torch.set_num_threads(1)
ATOL = 1e-5
LABELS = {i: f"lbl{i}" for i in range(6)}


def _carry(seed):
    kw = dict(outputdim=6, depth=2)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    params, state = jax_models.build(jcfg, jax.random.key(seed))
    cfg = models.get_model_config("uit_xxxs", **kw)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    return (jcfg, params, state), (cfg, model)


def _svc_cfg(pkg):
    return pkg.ServiceConfig(batch_size=4, max_seconds=2, warmup=False, max_wait_ms=2.0,
                             dtype="float32")


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


@pytest.fixture(scope="module")
def pair():
    """{'jax': (base, service), 'port': (base, service)} over one set of
    weights, plus the carried weights."""
    (jcfg, params, state), (cfg, model) = carried = _carry(0)
    jsvc = jax_serve.TaggingService(jcfg, params, state, _svc_cfg(jax_serve))
    psvc = serve.TaggingService(cfg, model, _svc_cfg(serve), device="cpu")
    servers = {"jax": jax_serve.make_http_server(jsvc, labels=LABELS, port=0,
                                                 model_name="uit_xxxs"),
               "port": serve.make_http_server(psvc, labels=LABELS, port=0,
                                              model_name="uit_xxxs")}
    yield {"jax": (_start(servers["jax"]), jsvc), "port": (_start(servers["port"]), psvc),
           "carried": carried}
    _stop(*servers.values())
    jsvc.close()
    psvc.close()


def _request(url, body=None, ctype="application/octet-stream"):
    """-> (status, parsed JSON) for a GET (body None) or POST, errors included."""
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _both(pair, path, body=None, ctype="application/octet-stream", bases=None):
    bases = bases or {k: pair[k][0] for k in ("jax", "port")}
    return {k: _request(bases[k] + path, body, ctype) for k in ("jax", "port")}


def _wav(n=16000, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _same_tag(out, want):
    assert out.keys() == want.keys()
    assert [t["index"] for t in out["top"]] == [t["index"] for t in want["top"]]
    assert [t["label"] for t in out["top"]] == [t["label"] for t in want["top"]]
    np.testing.assert_allclose([t["prob"] for t in out["top"]],
                               [t["prob"] for t in want["top"]], atol=ATOL, rtol=0)
    if "probs" in want:
        np.testing.assert_allclose(out["probs"], want["probs"], atol=ATOL, rtol=0)


def test_healthz_and_labels(pair):
    r = _both(pair, "/healthz")
    (jc, jh), (pc, ph) = r["jax"], r["port"]
    assert jc == pc == 200 and ph["status"] == "ok" and ph["model"] == "uit_xxxs"
    assert ph.keys() == jh.keys() | {"device"}
    assert (ph["platform"], ph["device"]) == (jh["platform"], "cpu") == ("cpu", "cpu")
    for k in ("sample_rate", "max_seconds", "batch_size", "weights_version", "calibrated"):
        assert ph[k] == jh[k], k
    r = _both(pair, "/labels")
    assert r["port"] == r["jax"] and r["port"][1]["3"] == "lbl3"


def test_healthz_stats_track_requests(pair):
    base, _ = pair["port"]
    _, before = _request(base + "/healthz")
    assert _request(base + "/tag?format=f32", _wav().tobytes())[0] == 200
    assert _request(base + "/tag", b"junk")[0] == 400  # counted as an error
    _, after = _request(base + "/healthz")
    assert after["requests"] >= before["requests"] + 2
    assert after["errors"] >= before["errors"] + 1
    assert after["latency_ms"]["p99"] >= after["latency_ms"]["p50"] is not None


def test_tag_wav_body_matches_jax(pair, tmp_path):
    p = tmp_path / "c.wav"
    write_wav(p, _wav())
    r = _both(pair, "/tag?k=3&full=1", p.read_bytes(), "audio/wav")
    assert r["jax"][0] == r["port"][0] == 200
    out = r["port"][1]
    assert len(out["top"]) == 3 and out["n_samples"] == 16000
    _same_tag(out, r["jax"][1])
    # against the port's service directly: the wav file round-trips through
    # int16 PCM, so the service gets the same quantized clip
    pcm = np.clip(_wav() * 32768.0, -32768, 32767).astype(np.int16)
    ref = pair["port"][1].submit(pcm.astype(np.float32) / 32768.0).result()
    np.testing.assert_allclose(out["probs"], ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fmt", ["f32", "pcm16"])
def test_tag_raw_formats(pair, fmt):
    wav = _wav(seed=1)
    body = (wav if fmt == "f32" else np.clip(wav * 32768.0, -32768, 32767).astype("<i2"))
    r = _both(pair, f"/tag?format={fmt}&full=1", body.tobytes())
    assert r["jax"][0] == r["port"][0] == 200
    _same_tag(r["port"][1], r["jax"][1])
    ref = pair["port"][1].submit(np.frombuffer(body.tobytes(), body.dtype)).result()
    np.testing.assert_allclose(r["port"][1]["probs"], ref, atol=1e-6, rtol=0)


def test_error_paths_match_jax(pair, tmp_path):
    p = tmp_path / "8k.wav"
    write_wav(p, _wav(8000), sample_rate=8000)
    cases = [("/nope", None, None), ("/nope", b"x", None), ("/tag", b"not audio", None),
             ("/tag?format=pcm16", b"abc", None), ("/tag", p.read_bytes(), "audio/wav"),
             ("/tag?format=pcm16", np.zeros(16000 * 3, dtype="<i2").tobytes(), None),
             ("/tag?format=f32", b"", None)]
    codes = []
    for path, body, ctype in cases:
        r = _both(pair, path, body, ctype or "application/octet-stream")
        assert r["port"][0] == r["jax"][0], path
        assert r["port"][1].keys() == r["jax"][1].keys() == {"error"}
        codes.append(r["port"][0])
    assert codes == [404, 404, 400, 400, 400, 413, 400]
    # no Content-Length -> 411
    for key in ("jax", "port"):
        host, port = pair[key][0].split("//")[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.putrequest("POST", "/tag?format=f32")
        conn.endheaders()
        assert conn.getresponse().status == 411
        conn.close()


@pytest.fixture(scope="module")
def events_pair(pair):
    """Second servers over the same services with /events on."""
    (jcfg, params, state), (cfg, model) = pair["carried"]
    jfw = jax_serve.make_framewise_fn(jcfg, params, state, max_seconds=2, use_pallas=False)
    pfw = serve.make_framewise_fn(cfg, model, max_seconds=2, device="cpu")
    servers = {"jax": jax_serve.make_http_server(pair["jax"][1], labels=LABELS, port=0,
                                                 framewise_fn=jfw),
               "port": serve.make_http_server(pair["port"][1], labels=LABELS, port=0,
                                              framewise_fn=pfw)}
    yield {k: _start(s) for k, s in servers.items()}, pfw, jfw
    _stop(*servers.values())


def test_events_endpoint_matches_jax(pair, events_pair):
    bases, pfw, jfw = events_pair
    assert not pfw.uses_kernel  # the CPU scorer runs the rfft reference
    wav = _wav(24000, seed=7)  # 1.5 s: padding and clamping
    probs, times = pfw(wav)
    jprobs, jtimes = jfw(wav)
    np.testing.assert_allclose(probs, jprobs, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(times, jtimes)
    # the module server has no framewise_fn -> 501 in both
    r = _both(pair, "/events?format=f32", wav.tobytes())
    assert r["port"][0] == r["jax"][0] == 501
    for q in ("threshold=0.4", "threshold=0.4&per_class=2:0.99", "threshold=0.5&median=3",
              "threshold=0.45&min_duration=0.5&merge_gap=0.2"):
        r = _both(pair, f"/events?format=f32&{q}", wav.tobytes(), bases=bases)
        (jc, jo), (pc, po) = r["jax"], r["port"]
        assert jc == pc == 200 and po.keys() == jo.keys()
        assert po["duration"] == pytest.approx(1.5)
        assert [(e["index"], e["label"]) for e in po["events"]] == [
            (e["index"], e["label"]) for e in jo["events"]]
        for a, b in zip(po["events"], jo["events"]):
            assert (a["onset"], a["offset"]) == pytest.approx((b["onset"], b["offset"]))
            assert a["offset"] <= 1.5
    # bad parameters -> 400 in both
    for bad in ("median=2", "per_class=x:0.5", "per_class=2:0.5:9", "per_class=-1:0.5",
                "per_class=99:0.5"):
        r = _both(pair, f"/events?format=f32&{bad}", wav.tobytes(), bases=bases)
        assert r["port"][0] == r["jax"][0] == 400, bad


@pytest.fixture(scope="module")
def stream_pair(pair):
    (jcfg, params, state), (cfg, model) = pair["carried"]
    jss = jax_serve.StreamSessions(jcfg, params, state, max_sessions=2,
                                   config=jax_serve.StreamingConfig(n_audioset=6))
    pss = serve.StreamSessions(cfg, model, max_sessions=2, device="cpu",
                               config=serve.StreamingConfig(n_audioset=6))
    servers = {"jax": jax_serve.make_http_server(pair["jax"][1], labels=LABELS, port=0,
                                                 stream_sessions=jss),
               "port": serve.make_http_server(pair["port"][1], labels=LABELS, port=0,
                                              stream_sessions=pss)}
    yield {k: _start(s) for k, s in servers.items()}, pss
    _stop(*servers.values())


def test_stream_sessions_match_jax(pair, stream_pair):
    bases, pss = stream_pair
    r = _both(pair, "/stream/open", b"")
    assert r["port"][0] == r["jax"][0] == 501  # no stream_sessions on the module server
    r = _both(pair, "/stream/open?on=0.3&off=0.2", b"", bases=bases)
    assert r["port"][1].keys() == r["jax"][1].keys()
    assert (r["port"][1]["window_seconds"], r["port"][1]["hop_seconds"]) == (1.0, 0.25)
    sid = {k: r[k][1]["id"] for k in r}
    chunks = [_wav(8000, seed=20), _wav(12000, seed=21), _wav(3000, seed=22),
              _wav(9000, seed=23)]  # ragged sizes: 0, 2, 0 and 3 windows
    for chunk, n in zip(chunks, (0, 2, 0, 3)):
        out = {k: _request(f"{bases[k]}/stream/{sid[k]}/feed?format=f32&k=2",
                           chunk.tobytes()) for k in bases}
        (jc, jo), (pc, po) = out["jax"], out["port"]
        assert jc == pc == 200 and po.keys() == jo.keys() and len(po["windows"]) == n
        for a, b in zip(po["windows"], jo["windows"]):
            assert a.keys() == b.keys() and a["time"] == pytest.approx(b["time"])
            assert [t["index"] for t in a["top"]] == [t["index"] for t in b["top"]]
            np.testing.assert_allclose([t["prob"] for t in a["top"]],
                                       [t["prob"] for t in b["top"]], atol=ATOL, rtol=0)
        assert [e["index"] for e in po["events"]] == [e["index"] for e in jo["events"]]
    closed = {k: _request(f"{bases[k]}/stream/{sid[k]}/close", b"") for k in bases}
    assert closed["port"][1].keys() == closed["jax"][1].keys() == {"events"}
    assert [(e["index"], e["onset"], e["offset"]) for e in closed["port"][1]["events"]] == [
        (e["index"], e["onset"], e["offset"]) for e in closed["jax"][1]["events"]]
    codes = []
    for k in bases:  # the closed session is gone
        codes.append(_request(f"{bases[k]}/stream/{sid[k]}/feed?format=f32",
                              chunks[0].tobytes())[0])
    assert codes == [404, 404]
    ids = {k: [] for k in bases}
    for _ in range(2):  # fill both slots; a third open is 429
        for k in bases:
            ids[k].append(_request(bases[k] + "/stream/open?on=0.4&per_class=1:0.9",
                                   b"")[1]["id"])
    r = _both(pair, "/stream/open", b"", bases=bases)
    assert r["port"][0] == r["jax"][0] == 429
    for k in bases:
        for i in ids[k]:
            assert _request(f"{bases[k]}/stream/{i}/close", b"")[0] == 200
    for q in ("per_class=x:y", "on=abc", "on=0.2&off=0.5"):
        r = _both(pair, f"/stream/open?{q}", b"", bases=bases)
        assert r["port"][0] == r["jax"][0] == 400, q
    # a refused open keeps its slot in the port (the JAX manager pops the
    # slot before it builds the detector, so off > on loses one there)
    assert len(pss._free) == pss.max_sessions


def test_stream_session_recycling_resets_slot(pair):
    _, (cfg, model) = pair["carried"]
    ss = serve.StreamSessions(cfg, model, max_sessions=1, device="cpu",
                              config=serve.StreamingConfig(n_audioset=6))
    a = ss.open()["id"]
    w, _ = ss.feed(a, _wav(20000, seed=30))  # 1.25 s -> 2 windows
    assert len(w) == 2
    ss.close(a)
    # the recycled slot starts from silence: same audio, same windows
    b = ss.open()["id"]
    w2, _ = ss.feed(b, _wav(20000, seed=30))
    assert [ev.time for ev in w2] == [ev.time for ev in w]
    np.testing.assert_array_equal(w2[0].probs, w[0].probs)
    ss.close(b)


def test_make_framewise_fn_rejects_other_families(pair):
    _, (_, model) = pair["carried"]
    with pytest.raises(TypeError, match="framewise"):
        serve.make_framewise_fn(object(), model, device="cpu")


def test_concurrent_requests_batch(pair):
    base, service = pair["port"]
    jbase = pair["jax"][0]
    wavs = [_wav(seed=10 + i) for i in range(8)]
    refs = [f.result() for f in [service.submit(w) for w in wavs]]
    results, errors = [None] * len(wavs), []

    def post(i):
        try:
            results[i] = _request(base + "/tag?format=f32&full=1", wavs[i].tobytes())[1]
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(wavs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and all(r is not None for r in results)
    for i, (out, ref) in enumerate(zip(results, refs)):
        np.testing.assert_allclose(out["probs"], ref, atol=1e-6, rtol=0)
        _same_tag(out, _request(jbase + "/tag?format=f32&full=1", wavs[i].tobytes())[1])


def test_metrics_endpoint(pair):
    texts = {}
    for k in ("jax", "port"):
        _request(pair[k][0] + "/tag?format=f32", _wav().tobytes())
        with urllib.request.urlopen(pair[k][0] + "/metrics", timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"].startswith("text/plain")
            texts[k] = r.read().decode()
    names = {k: [ln.split()[0] for ln in t.splitlines()] for k, t in texts.items()}
    assert names["port"] == names["jax"]
    text = texts["port"]
    assert "# TYPE uit_requests_total counter" in text and "uit_weights_version 1" in text
    assert 'uit_request_latency_ms{quantile="0.5"}' in text
    reqs = [ln for ln in text.splitlines() if ln.startswith("uit_requests_total")]
    assert len(reqs) == 1 and float(reqs[0].split()[1]) >= 1


def test_reload_endpoint(pair):
    (jcfg, params, state), (cfg, model) = pair["carried"]
    r = _both(pair, "/reload", b"")
    assert r["port"][0] == r["jax"][0] == 501
    _, (_, model2) = _carry(99)
    svc = serve.TaggingService(cfg, model, _svc_cfg(serve), device="cpu")
    fw1 = serve.make_framewise_fn(cfg, model, max_seconds=2, device="cpu")
    ss = serve.StreamSessions(cfg, model, max_sessions=2, device="cpu",
                              config=serve.StreamingConfig(n_audioset=6))

    def reload_fn():
        info = {"weights_version": svc.reload(model2)}
        info["_framewise_fn"] = serve.make_framewise_fn(cfg, model2, max_seconds=2,
                                                        device="cpu")
        info["stream_sessions"] = "reloaded" if ss.reload(cfg, model2) else "deferred"
        return info

    server = serve.make_http_server(svc, labels=LABELS, port=0, framewise_fn=fw1,
                                    stream_sessions=ss, reload_fn=reload_fn)
    base = _start(server)
    try:
        wav = _wav(seed=42)
        _, before = _request(base + "/tag?format=f32&full=1", wav.tobytes())
        _, ev_before = _request(base + "/events?format=f32&threshold=0.0", wav.tobytes())
        _, o = _request(base + "/stream/open", b"")
        code, rr = _request(base + "/reload", b"")
        assert code == 200 and rr["weights_version"] == 2
        assert rr["stream_sessions"] == "deferred" and rr["events"] == "reloaded"
        assert "_framewise_fn" not in rr
        assert _request(base + "/healthz")[1]["weights_version"] == 2
        _, after = _request(base + "/tag?format=f32&full=1", wav.tobytes())
        direct = serve.TaggingService(cfg, model2, _svc_cfg(serve), device="cpu")
        np.testing.assert_allclose(after["probs"], direct.submit(wav).result(), atol=1e-6,
                                   rtol=0)
        direct.close()
        assert not np.allclose(before["probs"], after["probs"])
        _, ev_after = _request(base + "/events?format=f32&threshold=0.0", wav.tobytes())
        assert ev_after["duration"] == ev_before["duration"] == 1.0
        _request(f"{base}/stream/{o['id']}/close", b"")
        code, r2 = _request(base + "/reload", b"")
        assert r2["weights_version"] == 3 and r2["stream_sessions"] == "reloaded"
    finally:
        _stop(server)
        svc.close()

    def broken():
        raise FileNotFoundError("checkpoint gone")

    server = serve.make_http_server(pair["port"][1], port=0, reload_fn=broken)
    try:
        code, err = _request(_start(server) + "/reload", b"")
        assert code == 500 and "checkpoint gone" in err["error"]
    finally:
        _stop(server)


@pytest.mark.parametrize("form", ["scalar", "vector", "json"])
def test_calibrated_service_matches_jax(pair, events_pair, tmp_path, form):
    """TaggingService(calibration=...) in its three forms: /tag gives
    apply_temperature of the uncalibrated probabilities, /events applies it
    before the thresholds, and both match the JAX package's calibrated
    server; the calibration survives reload()."""
    (jcfg, params, state), (cfg, model) = pair["carried"]
    T = {"scalar": 0.5, "vector": np.linspace(0.4, 2.5, 6), "json": None}[form]
    if form == "json":
        T = str(save_calibration(tmp_path / "cal.json", np.linspace(2.0, 0.3, 6)))
    temp = T if form != "json" else np.linspace(2.0, 0.3, 6)
    psvc = serve.TaggingService(cfg, model, _svc_cfg(serve), device="cpu", calibration=T)
    jsvc = jax_serve.TaggingService(jcfg, params, state, _svc_cfg(jax_serve), calibration=T)
    _, pfw, jfw = events_pair
    servers = {"jax": jax_serve.make_http_server(jsvc, labels=LABELS, port=0,
                                                 framewise_fn=jfw),
               "port": serve.make_http_server(psvc, labels=LABELS, port=0, framewise_fn=pfw)}
    bases = {k: _start(s) for k, s in servers.items()}
    try:
        wav = _wav(24000, seed=3)
        r = _both(pair, "/tag?format=f32&full=1", wav.tobytes(), bases=bases)
        _same_tag(r["port"][1], r["jax"][1])
        raw = pair["port"][1].submit(wav).result()
        np.testing.assert_allclose(r["port"][1]["probs"], apply_temperature(raw, temp),
                                   atol=1e-6, rtol=0)
        assert _request(bases["port"] + "/healthz")[1]["calibrated"] is True
        r = _both(pair, "/events?format=f32&threshold=0.5", wav.tobytes(), bases=bases)
        assert r["port"][1]["events"] and [e["index"] for e in r["port"][1]["events"]] == [
            e["index"] for e in r["jax"][1]["events"]]
        psvc.reload(model)
        again = _request(bases["port"] + "/tag?format=f32&full=1", wav.tobytes())[1]
        np.testing.assert_allclose(again["probs"], apply_temperature(raw, temp), atol=1e-6,
                                   rtol=0)
    finally:
        _stop(*servers.values())
        psvc.close()
        jsvc.close()


def test_refusals_name_their_roadmap_items(pair):
    _, (cfg, model) = pair["carried"]
    with pytest.raises(NotImplementedError, match="§A17"):
        serve.TaggingService(cfg, model, serve.ServiceConfig(data_parallel=True), device="cpu")
    # artifact serving is ported: a missing artifact is a missing file
    with pytest.raises(FileNotFoundError):
        serve.TaggingService.from_artifact("no_such_model.uitx", device="cpu")


def test_burst_beyond_the_stdlib_listen_backlog():
    """64 connections at once: every one is served (the stdlib server's
    listen backlog of 5 drops or resets the connections of such a burst)."""
    from concurrent.futures import Future, ThreadPoolExecutor

    class Instant:
        cfg = serve.ServiceConfig()

        def submit(self, wav):
            fut = Future()
            fut.set_result(np.full(6, 0.5, np.float32))
            return fut

    server = serve.make_http_server(Instant(), port=0)
    assert server.request_queue_size >= 64
    base = _start(server)
    body = np.zeros(1600, "<i2").tobytes()
    try:
        with ThreadPoolExecutor(64) as pool:
            codes = list(pool.map(lambda _: _request(base + "/tag?format=pcm16", body)[0],
                                  range(64)))
    finally:
        _stop(server)
    assert codes == [200] * 64


def test_closed_service_is_a_503_in_both(pair):
    """A /tag against a closed service answers 503 in both packages."""
    (jcfg, params, state), (cfg, model) = pair["carried"]
    services = {"jax": jax_serve.TaggingService(jcfg, params, state, _svc_cfg(jax_serve)),
                "port": serve.TaggingService(cfg, model, _svc_cfg(serve), device="cpu")}
    servers = {"jax": jax_serve.make_http_server(services["jax"], port=0),
               "port": serve.make_http_server(services["port"], port=0)}
    bases = {k: _start(s) for k, s in servers.items()}
    try:
        for svc in services.values():
            svc.close()
        r = _both(pair, "/tag?format=f32", _wav().tobytes(), bases=bases)
        assert r["port"][0] == r["jax"][0] == 503
        assert "closed" in r["port"][1]["error"]
    finally:
        _stop(*servers.values())
