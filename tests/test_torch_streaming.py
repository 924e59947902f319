"""The port's streaming tagger (serve/streaming.py) on the CPU against the
JAX package's: the same weights (carried through numpy) and the same audio
through both. Both run the exact plain frontend on the CPU, so window
probabilities agree within 1e-5; event times, triggers and online sound
events are equal. Inside the port, the device ring of feed_all and the
host path of feed() score each window in its stream's row of one batch
shape, so they agree bitwise, and int16 rings are bitwise the float32
ring fed k/32768."""

import jax
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.evaluate.calibration import apply_temperature as jax_apply_temperature
from uit_mobile_tpu.serve import streaming as jax_streaming
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.evaluate.calibration import apply_temperature, save_calibration
from uit_mobile_tpu_torch.frontend import normalize_pcm16
from uit_mobile_tpu_torch.ops import make_forward_fn
from uit_mobile_tpu_torch.serve import streaming

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def carried():
    kw = dict(outputdim=537, target_length=102, depth=2)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    cfg = models.get_model_config("uit_xxxs", **kw)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    return (jcfg, params, state), (cfg, model)


def _taggers(carried, n_streams=None, **sc_kw):
    """(JAX tagger, port tagger) over the same weights and config."""
    (jcfg, params, state), (cfg, model) = carried
    jsc = jax_streaming.StreamingConfig(**sc_kw)
    sc = streaming.StreamingConfig(**sc_kw)
    if n_streams is None:
        return (jax_streaming.StreamingTagger(jcfg, params, state, config=jsc),
                streaming.StreamingTagger(cfg, model, config=sc, device="cpu"))
    return (jax_streaming.MultiStreamTagger(jcfg, params, state, n_streams=n_streams,
                                            config=jsc),
            streaming.MultiStreamTagger(cfg, model, n_streams=n_streams, config=sc,
                                        device="cpu"))


def _same_events(got, want, atol=ATOL):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.stream, a.time) == (b.stream, pytest.approx(b.time))
        assert [c for c, _ in a.triggers] == [c for c, _ in b.triggers]
        np.testing.assert_allclose(a.probs, b.probs, atol=atol, rtol=0)


def _pcm(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 3000).astype(np.int16)


def test_hop_cadence_and_window_content(carried):
    jt, pt = _taggers(carried, hop_seconds=0.25)
    audio = (np.random.default_rng(0).standard_normal(32000) * 0.1).astype(np.float32)
    got, want = [], []
    for start in range(0, 32000, 1000):  # 62.5 ms chunks
        got += pt.feed_audio(audio[start:start + 1000])
        want += jt.feed_audio(audio[start:start + 1000])
    assert [e.time for e in got] == pytest.approx([1.0 + 0.25 * i for i in range(5)])
    _same_events(got, want)
    # the last window equals the direct forward on the last second
    _, (cfg, model) = carried
    direct = models.apply(cfg, model, torch.from_numpy(audio[None, -16000:])).numpy()
    np.testing.assert_allclose(got[-1].probs, direct[0], atol=1e-6, rtol=0)


def test_trigger_refractory(carried):
    jt, pt = _taggers(carried, hop_seconds=0.25, threshold=0.0, refractory_seconds=0.6)
    audio = np.zeros(24000, dtype=np.float32)
    got, want = pt.feed_audio(audio), jt.feed_audio(audio)
    assert len(got) == 3 and len(got[0].triggers) == 10
    assert got[1].triggers == [] and got[2].triggers == []
    _same_events(got, want)


def test_multi_stream_batched_step(carried):
    jt, pt = _taggers(carried, n_streams=3, hop_seconds=0.25)
    rng = np.random.default_rng(1)
    got, want = [], []
    for _ in range(8):  # 2 seconds
        chunks = rng.standard_normal((3, 4000)).astype(np.float32) * 0.1
        got += pt.feed_all(chunks)
        want += jt.feed_all(chunks)
    assert len(got) == 5 * 3 and {e.stream for e in got} == {0, 1, 2}
    _same_events(got, want)


def _detectors(**kw):
    return jax_streaming.OnlineEventDetector(**kw), streaming.OnlineEventDetector(**kw)


def _same_sound_events(got, want):
    assert [(e.stream, e.cls) for e in got] == [(e.stream, e.cls) for e in want]
    for a, b in zip(got, want):
        assert (a.onset, a.offset, a.peak_prob) == pytest.approx(
            (b.onset, b.offset, b.peak_prob))


def _drive(dets, steps, flush=True):
    """Feed (stream, time, probs) steps to both detectors -> closed events."""
    out = []
    for det in dets:
        evs = []
        for s, t, p in steps:
            evs += det.update(s, t, np.asarray(p, np.float32))
        if flush:
            evs += det.flush()
        out.append(evs)
    return out


def _p(n, **vals):
    p = np.zeros(n, np.float32)
    for k, v in vals.items():
        p[int(k[1:])] = v
    return p


@pytest.mark.parametrize("case", ["hysteresis", "hang", "min_duration", "streams",
                                  "subset", "per_class"])
def test_online_event_detector_matches_jax(case):
    """The JAX module's detector scenarios: both detectors close the same
    events at the same times."""
    if case == "hysteresis":
        kw = dict(on_threshold=0.5, off_threshold=0.3, n_audioset=4)
        steps = [(0, 1.0, _p(4, c2=0.4)), (0, 1.25, _p(4, c2=0.6)), (0, 1.5, _p(4, c2=0.4)),
                 (0, 1.75, _p(4, c2=0.1)), (0, 2.0, _p(4, c2=0.1))]
        want = [(0.25, 1.5)]
    elif case == "hang":
        kw = dict(on_threshold=0.5, off_threshold=0.5, hang_seconds=0.6, n_audioset=2)
        hi, lo = _p(2, c0=0.9), _p(2)
        steps = [(0, 1.0, hi), (0, 1.25, lo), (0, 1.5, hi), (0, 1.75, lo), (0, 2.0, lo),
                 (0, 2.25, lo)]
        want = [(0.0, 1.5)]
    elif case == "min_duration":
        kw = dict(on_threshold=0.5, off_threshold=0.5, min_duration=1.2, n_audioset=2)
        hi = _p(2, c0=0.9)
        steps = [(0, 1.0, hi), (0, 1.25, _p(2))] + [(0, 2.0 + 0.25 * k, hi) for k in range(4)]
        want = [(1.0, 2.75)]
    elif case == "streams":
        kw = dict(on_threshold=0.5, off_threshold=0.5, n_audioset=2)
        hi = _p(2, c0=0.9)
        steps = [(0, 1.0, hi), (1, 1.0, hi), (0, 1.5, _p(2))]
        want = [(0.0, 1.0), (0.0, 1.0)]
    elif case == "subset":
        kw = dict(on_threshold=0.5, off_threshold=0.5, classes=[3], n_audioset=8)
        steps = [(0, 1.0, _p(8, c1=0.9, c3=0.9))]
        want = [(0.0, 1.0)]
    else:
        kw = dict(on_threshold={2: 0.3, "default": 0.8}, off_threshold=0.3, n_audioset=4)
        steps = [(0, 1.0, _p(4, c1=0.5, c2=0.35))]
        want = [(0.0, 1.0)]
    got, ref = _drive(_detectors(**kw), steps)
    _same_sound_events(got, ref)
    assert [(e.onset, e.offset) for e in got] == pytest.approx(want)


def test_online_detector_thresholds_and_refusal():
    # spec entries beyond the tracked range are ignored, not an error
    got, ref = _drive(_detectors(on_threshold={530: 0.1, 1: 0.2}, off_threshold=0.1,
                                 n_audioset=4), [(0, 1.0, _p(4, c1=0.25))])
    assert [e.cls for e in got] == [1]
    _same_sound_events(got, ref)
    # a scalar pair with off > on fails fast (a ValueError in the port, an
    # AssertionError in the JAX package)
    with pytest.raises(ValueError, match="off <= on"):
        streaming.OnlineEventDetector(on_threshold=0.3, off_threshold=0.5)


def test_online_detector_on_tagger_output(carried):
    jt, pt = _taggers(carried, hop_seconds=0.5)
    dets = _detectors(on_threshold=0.0, off_threshold=0.0, classes=[0])
    rng = np.random.default_rng(0)
    closed = [[], []]
    for _ in range(4):
        chunk = rng.standard_normal(8000).astype(np.float32) * 0.1
        for i, (tagger, det) in enumerate(zip((jt, pt), dets)):
            for ev in tagger.feed_audio(chunk):
                closed[i] += det.update(ev.stream, ev.time, ev.probs)
    for i, det in enumerate(dets):
        closed[i] += det.flush()
    assert len(closed[1]) == 1 and closed[1][0].offset > closed[1][0].onset >= 0.0
    _same_sound_events(closed[1], closed[0])


def test_int16_buffers_bitwise_for_pcm_sources(carried):
    """int16 rings: bitwise the float32 ring's probabilities for PCM-sourced
    audio (raw int16, or its normalized float32 decoding re-quantized)."""
    _, (cfg, model) = carried
    pcm = _pcm(24000, 3)
    out = []
    for dtype, chunks in (("float32", normalize_pcm16(pcm)), ("int16", pcm),
                          ("int16", normalize_pcm16(pcm))):
        t = streaming.StreamingTagger(cfg, model, device="cpu",
                                      config=streaming.StreamingConfig(hop_seconds=0.5,
                                                                       dtype=dtype))
        out.append([ev for lo in range(0, 24000, 4000)
                    for ev in t.feed_audio(chunks[lo:lo + 4000])])
    assert len(out[0]) == len(out[1]) == len(out[2]) == 2
    for a, b, c in zip(*out):
        np.testing.assert_array_equal(a.probs, b.probs)
        np.testing.assert_array_equal(b.probs, c.probs)


def test_feed_all_matches_per_stream_feed(carried):
    """The device ring of feed_all against per-stream feed() (the host
    path): the same cadence and bitwise the same probabilities; both
    within 1e-5 of the JAX package's feed_all."""
    _, (cfg, model) = carried
    S, hop = 3, 4000
    audio = _pcm((S, 24000), 4)
    jt, t_vec = _taggers(carried, n_streams=S, hop_seconds=0.25, dtype="int16")
    t_seq = streaming.MultiStreamTagger(cfg, model, n_streams=S, device="cpu",
                                        config=t_vec.cfg)
    got_vec, got_seq, want = [], [], []
    for lo in range(0, 24000, hop):
        got_vec += t_vec.feed_all(audio[:, lo:lo + hop])
        want += jt.feed_all(audio[:, lo:lo + hop])
        assert t_vec._dev_buf is not None
        for s in range(S):
            got_seq += t_seq.feed(s, audio[s, lo:lo + hop])
    assert t_vec._host_stale  # the steady state never touched the host mirror
    key = lambda e: (e.time, e.stream)  # noqa: E731
    for a, b in zip(sorted(got_vec, key=key), sorted(got_seq, key=key)):
        assert (a.stream, a.time) == (b.stream, b.time)
        np.testing.assert_array_equal(a.probs, b.probs)
    _same_events(got_vec, want)


def test_mixed_feed_after_device_ring_rebuilds_host(carried):
    """After steady-state feed_all hops, per-stream feed() rebuilds the
    stale host mirror from the device ring: window content stays exact."""
    _, (cfg, model) = carried
    S, hop = 2, 4000
    audio = _pcm((S, 40000), 5)
    jt, t_mix = _taggers(carried, n_streams=S, hop_seconds=0.25, dtype="int16")
    t_ref = streaming.MultiStreamTagger(cfg, model, n_streams=S, device="cpu",
                                        config=t_mix.cfg)
    for lo in range(0, 24000, hop):
        t_mix.feed_all(audio[:, lo:lo + hop])
        jt.feed_all(audio[:, lo:lo + hop])
        for s in range(S):
            t_ref.feed(s, audio[s, lo:lo + hop])
    got, ref, want = [], [], []
    for lo in range(24000, 40000, hop):
        for s in range(S):
            got += t_mix.feed(s, audio[s, lo:lo + hop])
            ref += t_ref.feed(s, audio[s, lo:lo + hop])
            want += jt.feed(s, audio[s, lo:lo + hop])
    assert t_mix._dev_buf is None and not t_mix._host_stale
    for a, b in zip(got, ref):
        assert (a.stream, a.time) == (b.stream, b.time)
        np.testing.assert_array_equal(a.probs, b.probs)
    _same_events(got, want)


def test_reset_stream_clears_one_slot(carried):
    """reset_stream after device-ring hops: the slot restarts from silence
    (its next window scores only audio fed after the reset), the other
    slots keep their rings, the port and the JAX package agree."""
    S = 2
    audio = _pcm((S, 32000), 6)
    jt, pt = _taggers(carried, n_streams=S, hop_seconds=0.25, threshold=0.0,
                      refractory_seconds=10.0, dtype="int16")
    for lo in range(0, 16000, 4000):
        pt.feed_all(audio[:, lo:lo + 4000])
        jt.feed_all(audio[:, lo:lo + 4000])
    for t in (pt, jt):
        t.reset_stream(1)
    assert pt._dev_buf is None and not pt._host_stale
    got, want = [], []
    for lo in range(16000, 32000, 4000):
        got += pt.feed(1, audio[1, lo:lo + 4000]) + pt.feed(0, audio[0, lo:lo + 4000])
        want += jt.feed(1, audio[1, lo:lo + 4000]) + jt.feed(0, audio[0, lo:lo + 4000])
    # stream 1 refilled its window from the reset on: one window at t=1.0,
    # its keywords fire again (the refractory history went with the reset)
    s1 = [e for e in got if e.stream == 1]
    assert [e.time for e in s1] == [1.0] and len(s1[0].triggers) == 10
    _same_events(got, want)
    fresh = streaming.MultiStreamTagger(carried[1][0], carried[1][1], n_streams=S,
                                        config=pt.cfg, device="cpu")
    np.testing.assert_array_equal(s1[0].probs, fresh.feed(1, audio[1, 16000:32000])[0].probs)


@pytest.mark.parametrize("form", ["scalar", "vector", "json"])
def test_calibration_before_triggers(carried, tmp_path, form):
    """A calibrated tagger emits apply_temperature of the uncalibrated
    probabilities, fires its keyword triggers on the calibrated ones, and
    matches the JAX package's calibrated tagger."""
    (jcfg, params, state), (cfg, model) = carried
    T = {"scalar": 1.7,
         "vector": np.linspace(0.5, 2.0, 537),
         "json": None}[form]
    if form == "json":
        T = save_calibration(tmp_path / "cal.json", 0.25)
    sc = streaming.StreamingConfig(hop_seconds=0.5, threshold=0.3, refractory_seconds=0.0)
    plain = streaming.StreamingTagger(cfg, model, config=sc, device="cpu")
    cal = streaming.StreamingTagger(cfg, model, config=sc, calibration=T, device="cpu")
    jcal = jax_streaming.StreamingTagger(
        jcfg, params, state, config=jax_streaming.StreamingConfig(
            hop_seconds=0.5, threshold=0.3, refractory_seconds=0.0),
        calibration=str(T) if form == "json" else T)
    audio = (np.random.default_rng(8).standard_normal(32000) * 0.1).astype(np.float32)
    got, raw, want = cal.feed_audio(audio), plain.feed_audio(audio), jcal.feed_audio(audio)
    temp = 0.25 if form == "json" else T
    for g, r in zip(got, raw):
        np.testing.assert_allclose(g.probs, apply_temperature(r.probs, temp), atol=1e-6, rtol=0)
        fired = np.flatnonzero(g.probs[527:] >= 0.3) + 527
        assert [c for c, _ in g.triggers] == fired.tolist()
    np.testing.assert_allclose(apply_temperature(raw[0].probs, temp),
                               jax_apply_temperature(raw[0].probs, temp), atol=1e-7)
    _same_events(got, want)


def test_kernel_route_at_the_tfb_floor(carried):
    """use_kernel=True on the CPU runs the fast kernel's plain version: at
    S >= 128 streams in the 'tfb' layout, the device ring's windows equal
    make_forward_fn(precision='fast', top_db_mode='per_sample') on them."""
    _, (cfg, model) = carried
    S = 128
    sc = streaming.StreamingConfig(hop_seconds=0.5, use_kernel=True, dtype="int16")
    t = streaming.MultiStreamTagger(cfg, model, n_streams=S, config=sc, device="cpu")
    audio = _pcm((S, 24000), 9)
    evs = []
    for lo in range(0, 24000, 8000):
        evs += t.feed_all(audio[:, lo:lo + 8000])
    assert len(evs) == 2 * S
    fwd = make_forward_fn(cfg, model, use_kernel=True, precision="fast",
                          top_db_mode="per_sample")
    want = fwd(audio[:, 8000:24000]).numpy()
    np.testing.assert_array_equal(np.stack([e.probs for e in evs[S:]]), want)


def test_refusals(carried):
    _, (cfg, model) = carried
    t = streaming.MultiStreamTagger(cfg, model, n_streams=2, device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        t.feed_all(np.zeros((3, 4000), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        streaming.MultiStreamTagger(cfg, model, device="cpu",
                                    config=streaming.StreamingConfig(dtype="float16"))
