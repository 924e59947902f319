"""The port's bench CLI (cli/bench.py) with --device cpu at a tiny size,
every mode: one JSON record each, finite numbers, and every field name that
the JAX CLI prints as ``name=value`` in the same mode (run on the same
arguments here) among the record's keys."""

import json
import math
import re

import pytest
import torch

from uit_mobile_tpu.cli.bench import main as jax_bench_main
from uit_mobile_tpu_torch.cli.bench import main as bench_main

torch.set_num_threads(1)
TINY = ["-m", "uit_xxxs", "-b", "4"]
MODES = {
    "forward": [],
    "frontend": ["--frontend-only", "--exact"],
    "scan": ["--scan", "2", "--dtype", "int16"],
    "serve": ["--serve", "--serve-requests", "8", "--serve-concurrency", "4"],
    "stream": ["--stream", "--streams", "4", "--dtype", "int16"],
    "train": ["--train"],
    "train_tfb_scan": ["--train", "--train-layout", "tfb", "--scan", "2"],
}
# the JAX CLI's train mode jit-compiles the PSL step (~20 s here): its names
# are read from the bft run only
JAX_MODES = ("forward", "frontend", "scan", "serve", "stream", "train")


def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


@pytest.fixture(scope="module")
def records():
    import contextlib
    import io

    out = {}
    for mode, extra in MODES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert bench_main(TINY + extra + ["--device", "cpu"]) == 0
        lines = buf.getvalue().splitlines()
        assert len(lines) == 1
        out[mode] = json.loads(lines[0])
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_record_is_finite_and_names_its_card(records, mode):
    rec = records[mode]
    assert (rec["device"], rec["device_name"], rec["card"]) == ("cpu", "cpu", None)
    assert rec["mode"] == {"scan": "forward", "train_tfb_scan": "train"}.get(mode, mode)
    assert all(math.isfinite(x) for x in _numbers(rec))
    assert set(rec["launches"]) == {"row_exact", "row_fast", "tfb_exact", "tfb_fast"}


@pytest.mark.parametrize("mode", JAX_MODES)
def test_field_names_match_the_jax_cli(records, capsys, mode):
    assert jax_bench_main(TINY + MODES[mode]) == 0
    printed = capsys.readouterr().out
    # the scan count, "K=" in the JAX label, is the record's "scan" (the flag)
    names = {"scan" if n == "K" else n for n in re.findall(r"(\w+)=", printed)}
    assert names <= records[mode].keys(), (names - records[mode].keys(), printed)
    if mode == "stream":  # the JAX line states its numbers without names
        assert re.search(r"4 streams @ hop 0.25s -> [\d.]+ windows/s", printed)
        assert records[mode]["streams"] == 4 and records[mode]["hop"] == 0.25
        assert records[mode]["realtime_streams"] == pytest.approx(
            records[mode]["windows_per_s"] * 0.25)


def test_profile_and_refusals(tmp_path, capsys):
    assert bench_main(TINY + ["--profile", str(tmp_path / "prof"), "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["trace"] == str(tmp_path / "prof") and rec["device_dispatch_ms"] == []
    assert list((tmp_path / "prof").glob("*.trace.json.gz"))
    # bfloat16 compute is ported: the bench runs it and says so
    assert bench_main(TINY + ["--compute-dtype", "bfloat16", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["compute_dtype"] == "bfloat16" and all(math.isfinite(x) for x in _numbers(rec))
    with pytest.raises(SystemExit):
        bench_main(["-m", "MobileNetV2", "-b", "4", "--train", "--train-layout", "tfb",
                    "--device", "cpu"])


@pytest.mark.parametrize("k, offset", [(1, 0), (4, 3)])
def test_block_builder_matches_jax(k, offset):
    """ops.pipeline.make_block_builder against the JAX package's: the same
    (K, B, T) block from the same two batches."""
    import numpy as np

    from uit_mobile_tpu.ops.pipeline import make_block_builder as jax_make_block_builder
    from uit_mobile_tpu_torch.ops import make_block_builder

    rng = np.random.default_rng(k)
    a, b = (rng.standard_normal((5, 7)).astype(np.float32) for _ in range(2))
    got = make_block_builder(k)(torch.from_numpy(a), torch.from_numpy(b), offset).numpy()
    want = np.asarray(jax_make_block_builder(k)(a, b, offset))
    assert got.shape == (k, 5, 7)
    np.testing.assert_array_equal(got, want)
