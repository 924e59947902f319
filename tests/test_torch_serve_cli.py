"""The port's serving CLIs (cli/serve.py, cli/stream.py) with --device cpu
against the JAX package's CLIs on the same checkpoint (a JAX npz, which the
port reads) and the same input: the same JSON lines, labels equal, printed
probabilities within 1.5e-4 (both print 4 decimals; the packages differ by
~1e-7 before rounding, so a value may round the other way), window times,
triggers and events equal. Run in-process with stdin and stdout patched."""

import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save
from uit_mobile_tpu.cli.serve import main as jax_serve_main
from uit_mobile_tpu.cli.stream import main as jax_stream_main
from uit_mobile_tpu_torch.cli.serve import main as serve_main
from uit_mobile_tpu_torch.cli.stream import main as stream_main
from uit_mobile_tpu_torch.evaluate.calibration import save_calibration
from uit_mobile_tpu_torch.evaluate.events import save_thresholds

REPO = Path(__file__).resolve().parent.parent
WAVS = ["samples/85b877b5_nohash_0.wav", "samples/water_000.wav"]
PRINTED = 1.5e-4


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two JAX-written uit_xxxs checkpoints (depth 2), seeds 0 and 1."""
    cfg = jax_models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=2)
    out = []
    for seed in (0, 1):
        params, state = jax_models.build(cfg, jax.random.key(seed))
        path = tmp_path_factory.mktemp("ckpt") / f"m{seed}.npz"
        jax_save(path, params, state, cfg)
        out.append(path)
    return out


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def _run(main, argv, capsys, monkeypatch, stdin=None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", stdin)
    assert main(argv) == 0
    return _lines(capsys)


def _same_rows(got, want):
    """[label, prob] rows: labels equal, probabilities as printed."""
    assert [lab for lab, _ in got] == [lab for lab, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=PRINTED, rtol=0)


@pytest.mark.parametrize("extra", [[], ["--calibration", "CAL"]])
def test_serve_cli_stdin_json_matches_jax(ckpts, tmp_path, capsys, monkeypatch, extra):
    if extra:
        extra = ["--calibration", str(save_calibration(tmp_path / "cal.json", 1.8))]
    monkeypatch.chdir(REPO)
    argv = ["-m", str(ckpts[0]), "-k", "3", "--batch-size", "4", "--max-seconds", "2",
            "--no-warmup", *extra]
    got = _run(serve_main, argv + ["--device", "cpu"], capsys, monkeypatch,
               io.StringIO("\n".join(WAVS) + "\n"))
    want = _run(jax_serve_main, argv, capsys, monkeypatch, io.StringIO("\n".join(WAVS) + "\n"))
    assert [g["path"] for g in got] == [w["path"] for w in want] == WAVS
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and len(g["top"]) == 3
        _same_rows(g["top"], w["top"])


def test_console_entry_points_import():
    import importlib

    for mod in ("infer", "train", "evaluate", "bench", "serve", "stream"):
        m = importlib.import_module(f"uit_mobile_tpu_torch.cli.{mod}")
        assert callable(m.main)


def _stream_lines(main, argv, capsys, monkeypatch, stdin=None):
    return _run(main, argv, capsys, monkeypatch, stdin)


def _same_stream(got, want):
    assert [g["kind"] for g in got] == [w["kind"] for w in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if g["kind"] == "window":
            assert g["t"] == w["t"]
            _same_rows(g["top"], w["top"])
        elif g["kind"] == "trigger":
            assert (g["t"], g["keyword"]) == (w["t"], w["keyword"])
            assert g["prob"] == pytest.approx(w["prob"], abs=PRINTED)
        else:
            assert (g["label"], g["onset"], g["offset"]) == (w["label"], w["onset"],
                                                             w["offset"])
            assert g["peak"] == pytest.approx(w["peak"], abs=PRINTED)


@pytest.mark.parametrize("variant", ["always_on", "thresholds_file"])
def test_stream_cli_wav_and_events_match_jax(ckpts, tmp_path, capsys, monkeypatch, variant):
    monkeypatch.chdir(REPO)
    argv = [WAVS[0], WAVS[1], "-m", str(ckpts[0]), "--hop", "0.25", "--windows", "--events",
            "--threshold", "0.3"]
    if variant == "always_on":
        argv += ["--on-threshold", "0.0", "--off-threshold", "0.0", "--track-classes",
                 "0,5,137"]
    else:
        th = tmp_path / "th.json"
        save_thresholds(th, {0: 0.45, 3: 0.5}, default=0.52)
        argv += ["--thresholds", str(th), "--off-threshold", "0.4", "--hang", "0.25"]
    got = _stream_lines(stream_main, argv + ["--device", "cpu"], capsys, monkeypatch)
    want = _stream_lines(jax_stream_main, argv, capsys, monkeypatch)
    windows = [g for g in got if g["kind"] == "window"]
    assert windows and all(len(w["top"]) == 3 for w in windows)
    if variant == "always_on":  # the always-on detector closes every tracked class
        assert len({g["label"] for g in got if g["kind"] == "event"}) == 3
    _same_stream(got, want)


def test_stream_cli_raw_stdin_matches_jax(ckpts, capsys, monkeypatch):
    pcm = (np.random.default_rng(0).standard_normal(24001) * 3000).astype("<i2")
    # a trailing odd byte (a stream cut mid-sample) is dropped

    class FakeStdin:
        def __init__(self, data):
            self.buffer = io.BytesIO(data)

    argv = ["--raw", "-m", str(ckpts[0]), "--hop", "0.5", "--windows", "--threshold", "0.3"]
    data = pcm.tobytes() + b"\x01"
    got = _stream_lines(stream_main, argv + ["--device", "cpu"], capsys, monkeypatch,
                        FakeStdin(data))
    want = _stream_lines(jax_stream_main, argv, capsys, monkeypatch, FakeStdin(data))
    assert [g["t"] for g in got if g["kind"] == "window"] == [1.0, 1.5]
    _same_stream(got, want)


@pytest.mark.parametrize("argv", [[], ["samples/water_000.wav", "--raw"],
                                  ["samples/water_000.wav", "--track-classes", "600"]])
def test_stream_cli_rejects_bad_arguments(ckpts, monkeypatch, argv):
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit):
        stream_main(argv + ["-m", str(ckpts[0]), "--device", "cpu"])


def test_serve_cli_low_latency_preset(ckpts, capsys, monkeypatch):
    """--low-latency routes through ServiceConfig.low_latency(); a
    non-default --dtype still overrides it."""
    from uit_mobile_tpu_torch.serve import TaggingService

    captured = {}
    orig = TaggingService.__init__

    def spy(self, model_cfg, model, config, **kw):
        captured["cfg"], captured["kw"] = config, kw
        return orig(self, model_cfg, model, config, **kw)

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(TaggingService, "__init__", spy)
    got = _run(serve_main, ["-m", str(ckpts[0]), "--low-latency", "--max-seconds", "2",
                            "--no-warmup", "--dtype", "float32", "--device", "cpu"],
               capsys, monkeypatch, io.StringIO("samples/water_000.wav\n"))
    conf = captured["cfg"]
    assert (conf.max_wait_ms, conf.scan_batches, conf.batch_size, conf.dtype) == (
        0.0, 1, 8, "float32")
    assert captured["kw"]["device"] == "cpu"
    assert got[0]["path"] == "samples/water_000.wav"


def test_serve_cli_refusals_name_their_roadmap_items(ckpts, capsys, monkeypatch):
    # artifact serving is ported: a missing artifact is a missing file
    with pytest.raises(FileNotFoundError):
        serve_main(["--artifact", "no_such_model.uitx", "--device", "cpu"])
    # --data-parallel is ported: one CPU device serves as the single-device path
    monkeypatch.chdir(REPO)
    got = _run(serve_main, ["-m", str(ckpts[0]), "--data-parallel", "--device", "cpu",
                            "--batch-size", "4", "--max-seconds", "2", "--no-warmup"],
               capsys, monkeypatch, io.StringIO(WAVS[0] + "\n"))
    assert [g["path"] for g in got] == [WAVS[0]]


def test_serve_cli_http_wiring_and_reload(ckpts, tmp_path, monkeypatch):
    """--http: the server gets a /events scorer, stream sessions and a
    reload_fn that re-reads the checkpoint it was started from."""
    import shutil

    import torch

    from uit_mobile_tpu_torch import serve
    from uit_mobile_tpu_torch.cli.common import resolve_model
    from uit_mobile_tpu_torch.frontend import quantize_pcm16
    from uit_mobile_tpu_torch.ops import make_forward_fn

    live = tmp_path / "live.npz"
    shutil.copyfile(ckpts[0], live)
    wav = (np.random.default_rng(1).standard_normal(16000) * 0.1).astype(np.float32)
    seen = {}

    def fake_serve_http(service, **kw):
        seen.update(kw)
        seen["before"] = service.submit(wav).result(timeout=60)
        shutil.copyfile(ckpts[1], live)  # new weights dropped in place
        seen["info"] = kw["reload_fn"]()  # as POST /reload does
        seen["after"] = service.submit(wav).result(timeout=60)

    monkeypatch.setattr(serve, "serve_http", fake_serve_http)
    assert serve_main(["-m", str(live), "--http", "0", "--max-seconds", "2", "--no-warmup",
                       "--batch-size", "4", "--stream-sessions", "3", "--device", "cpu"]) == 0
    assert seen["framewise_fn"] is not None and seen["stream_sessions"].max_sessions == 3
    info = seen["info"]
    assert info["weights_version"] == 2 and info["stream_sessions"] == "reloaded"
    assert info["source"] == str(live) and "_framewise_fn" in info
    pcm = torch.from_numpy(quantize_pcm16(wav)[None])  # the CLI serves int16
    for ckpt, key in ((ckpts[0], "before"), (ckpts[1], "after")):
        cfg, model = resolve_model(str(ckpt), device="cpu")
        want = make_forward_fn(cfg, model, top_db_mode="per_sample")(pcm)[0].numpy()
        np.testing.assert_allclose(seen[key], want, atol=1e-6, rtol=0)
