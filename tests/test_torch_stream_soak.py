"""Soak: the port's /stream session manager (serve/http.py StreamSessions)
under concurrent load across reloads, modelled on tests/test_stream_soak.py.

Worker threads open, feed (random chunk sizes) and close sessions while a
reloader thread keeps calling ``reload()``, alternating two sets of
weights. The contract:

- ``reload`` never swaps while a session is active (returns False) and
  succeeds once the slots drain;
- every session's windows are scored by the weights that were live when it
  was fed: each session equals, bitwise, the same audio fed to a fresh
  tagger in the same slot under ONE of the two weight sets (never a
  splice of both);
- worker errors are only the expected capacity error (LookupError); no
  deadlock; after the storm every slot is free, and a post-reload session
  scores with the new weights (within 1e-5 of the JAX package's forward).
"""

from __future__ import annotations

import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.serve import MultiStreamTagger, StreamingConfig, StreamSessions

torch.set_num_threads(1)
CONFIG = StreamingConfig(hop_seconds=0.5)


@pytest.fixture(scope="module")
def model():
    kw = dict(outputdim=537, target_length=102, depth=2)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    cfg = models.get_model_config("uit_xxxs", **kw)
    out = []
    for seed in (0, 1):
        params, state = jax_models.build(jcfg, jax.random.key(seed))
        out.append(((params, state), module_from_numpy(
            cfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
            device="cpu")))
    return jcfg, cfg, out


def test_stream_soak_across_reloads(model):
    jcfg, cfg, ((_, m_a), ((params_b, state_b), m_b)) = model
    ss = StreamSessions(cfg, m_a, config=CONFIG, max_sessions=4, device="cpu")
    stop = threading.Event()
    errors: list = []
    sessions: list = []  # (slot, chunks, windows) of every closed session
    swaps = {"ok": 0, "denied": 0}

    def worker(seed: int):
        rng, npr = random.Random(seed), np.random.default_rng(seed)
        while not stop.is_set():
            try:
                sid = ss.open()["id"]
            except LookupError:
                time.sleep(0.002)  # all slots busy: expected under the storm
                continue
            try:
                slot = ss._sessions[sid]["slot"]
                chunks, windows = [], []
                for _ in range(rng.randint(1, 4)):
                    chunk = (npr.standard_normal(rng.choice([400, 4000, 9000]))
                             .astype(np.float32) * 0.05)
                    chunks.append(chunk)
                    windows += ss.feed(sid, chunk)[0]
                ss.close(sid)
                sessions.append((slot, chunks, windows))
            except Exception as e:  # noqa: BLE001 - the soak's point: collect, assert below
                errors.append(e)
                return

    def reloader():
        live = 0
        while not stop.is_set():
            try:
                if ss.reload(cfg, (m_b, m_a)[live]):
                    live ^= 1
                    swaps["ok"] += 1
                else:
                    swaps["denied"] += 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
            time.sleep(0.01)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    threads.append(threading.Thread(target=reloader))
    for t in threads:
        t.start()
    time.sleep(4.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "soak thread deadlocked"
    assert not errors, f"unexpected errors under the storm: {errors[:3]}"
    scored = [s for s in sessions if s[2]]
    assert scored, "the storm never produced a scored window"

    # every session is one weight set's, bitwise
    refs = {id(m): MultiStreamTagger(cfg, m, n_streams=4, config=CONFIG, device="cpu")
            for m in (m_a, m_b)}
    for slot, chunks, windows in scored[:40]:
        matches = []
        for ref in refs.values():
            ref.reset_stream(slot)
            want = [ev for c in chunks for ev in ref.feed(slot, c)]
            matches.append(len(want) == len(windows) and all(
                (a.time == b.time and np.array_equal(a.probs, b.probs))
                for a, b in zip(windows, want)))
        assert sum(matches) == 1, "a session's windows are not one weight set's"

    # drained: the reload goes through and every slot is free
    assert ss.active_sessions == 0
    assert ss.reload(cfg, m_b) is True
    assert len(ss._free) == ss.max_sessions
    sid = ss.open()["id"]
    audio = (np.random.default_rng(7).standard_normal(16000).astype(np.float32) * 0.05)
    windows, _ = ss.feed(sid, audio)
    ss.close(sid)
    assert len(windows) == 1
    direct = np.asarray(jax_models.apply(jcfg, params_b, state_b, jnp.asarray(audio[None])))
    np.testing.assert_allclose(windows[0].probs, direct[0], atol=1e-5, rtol=0)


def test_reload_denied_while_single_session_open(model):
    _, cfg, ((_, m_a), (_, m_b)) = model
    ss = StreamSessions(cfg, m_a, config=CONFIG, max_sessions=2, device="cpu")
    sid = ss.open()["id"]
    assert ss.reload(cfg, m_b) is False  # deferred, not an error
    ss.close(sid)
    assert ss.reload(cfg, m_b) is True


def test_session_slots_survive_idle_expiry_storm(model):
    """Sessions that are never closed expire lazily; slots recycle (no leak)
    and an expired id raises KeyError."""
    _, cfg, ((_, m_a), _) = model
    ss = StreamSessions(cfg, m_a, config=CONFIG, max_sessions=2, idle_seconds=0.05,
                        device="cpu")
    ids = []
    for _ in range(10):  # 5x the slot count, relying on expiry to recycle
        ids.append(ss.open()["id"])
        time.sleep(0.06)
    active = ss.active_sessions  # the property expires first
    assert active + len(ss._free) == ss.max_sessions
    with pytest.raises(KeyError):
        ss.feed(ids[0], np.zeros(100, np.float32))
