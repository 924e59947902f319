"""BENCHMARK.json and the harness against the benchmark's contract, on the CPU:
every cell loads by name, a cell, a traffic mix and a metric are added by
files alone, the last line's schema, no run without a card, and nothing of
JAX or the JAX package in what the harness loads."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keep_to_the_contract():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench_port/")
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert harness.metric_file(m["name"]).is_file(), m["name"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert harness.driver(cell).setup
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:  # a metric reports where the metric it moves is reported
        assert m["moves"] in e2e
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_configs_reduce_nothing_and_name_their_source():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_a_cell_a_mix_and_a_metric_from_new_files_alone(tmp_path):
    """In a copy: a new traffic file, a new metric reader and new entries in
    BENCHMARK.json make a new cell that loads and reads, no file edited."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((ROOT / "bench_port/traffic/train.as10.json").read_text())
    traffic["batch"] = 16
    (tmp_path / "bench_port/traffic/train.as10_b16.json").write_text(json.dumps(traffic))
    (tmp_path / "bench_port/metrics/train.steps.py").write_text(
        "def read(run):\n    return run.get('steps')\n")
    bench["workloads"].append({"name": "uit_xs_moe.train.as10_b16", "config": "uit_xs_moe",
                               "traffic": "train.as10_b16", "chips": 1, "why": "half the batch"})
    bench["per_layer"].append({"name": "train.steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_clips_per_s",
                               "workloads": ["uit_xs_moe.train.as10_b16"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "uit_xs_moe.train.as10" in m.get("workloads", ()):
            m["workloads"].append("uit_xs_moe.train.as10_b16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from bench_port import harness;"
            "c = harness.load_cell('uit_xs_moe.train.as10_b16');"
            "assert c.traffic['batch'] == 16;"
            "names = [m['name'] for m in c.per_layer];"
            "assert {'train.steps', 'idle.train'} <= set(names), names;"
            "print(harness.metric_reader('train.steps')({'steps': 7}))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7"


def test_last_line_schema():
    cell = harness.load_cell("uit_xs_moe.train.as10")
    record = {"window_s": 2.0, "setup_s": 3.5, "attempted": 10, "failed": 0, "steps": 10,
              "batch": 32, "flops": 1e12, "mel_bound_s": 1e-5,
              "trace": {"busy_s": 0.5, "window_s": 1.0,
                        "ops": {"mel_kernel<short,false,6>": (2, 4e-5), "gemm": (3, 0.4)},
                        "gaps": [("traced_window", 0.3), ("step", 0.2)]}}
    checks = [harness.Check("loss_gap", 1e-6, 1e-4)]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1}
    line = harness.result_line(cell, record, checks, False, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_clips_per_s", "setup_s"}
    assert line["metrics"]["train_clips_per_s"] == {"value": 160.0, "unit": "clips/s"}
    traced = harness.result_line(cell, record, [harness.Check("loss_gap", 1.0, 1e-4)], True,
                                 device)
    assert list(traced)[-1] == "checks" and traced["correct"] is False
    assert set(traced["metrics"]) == {"mfu.train", "mel_roofline.train", "idle.train"}
    assert traced["metrics"]["mel_roofline.train"]["value"] == pytest.approx(50.0)
    assert traced["metrics"]["idle.train"]["value"] == pytest.approx(50.0)
    assert traced["device"]["busy_s"] == 0.5 and traced["device"]["window_s"] == 1.0
    assert traced["breakdown"]["device_ops"][0] == ["gemm", 0.4]
    assert len(traced["breakdown"]["idle_gaps"]) <= 10
    json.dumps(traced)


def test_summarize_trace_unions_device_time_and_labels_gaps():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, a, b, dev):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                               device_type=dev)

    events = [ev("bench.traced_window", 0, 100, DeviceType.CPU),
              ev("bench.feed_all", 10, 60, DeviceType.CPU),
              ev("bench.feed_all", 10, 60, DeviceType.CUDA),  # a span's device range
              ev("k1", 5, 20, DeviceType.CUDA), ev("k2", 15, 30, DeviceType.CUDA),
              ev("memcpy", 70, 80, DeviceType.CUDA)]
    t = harness.summarize_trace(events, (0, 100))
    assert t["busy_s"] == pytest.approx(35e-6) and t["window_s"] == pytest.approx(100e-6)
    assert t["ops"]["k1"] == (1, pytest.approx(15e-6))
    labels = dict((label, s) for label, s in t["gaps"] if label == "feed_all")
    assert labels["feed_all"] == pytest.approx(40e-6)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing."""
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "uit_xs_moe.train.as10",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    """BENCHMARK.json and bench_port/ without the program: no result."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time, torch; sys.path.insert(0, sys.argv[1]);"
            "from bench_port import harness;"
            "c = harness.load_cell('uit_xs_moe.train.as10');"
            "harness.run_cell(c, 1, 1.0, False, torch.device('cpu'), time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "uit_mobile_tpu_torch" in out.stderr
    assert out.stdout == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "uit_mobile_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench_port").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (ROOT / "bench_port" / "reference").rglob("*.py"):
        assert "uit_mobile_tpu_torch" not in _imports(path), path
    for path in (ROOT / "bench_port" / "counts").rglob("*.py"):
        assert "uit_mobile_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_jax_module():
    """A whole small run of each driver, then sys.modules by whole top-level
    names (``uit_mobile_tpu_torch`` is the port, not the JAX package)."""
    code = ("import sys, time, torch; sys.path.insert(0, sys.argv[1]);"
            "from bench_port import harness;"
            "small = dict(depth=1, batch=8, clip_seconds=1.0, host_batches=4, scene_seconds=20);"
            "c = harness.load_cell('uit_xs_moe.train.as10');"
            "harness.run_cell(c, 5, 0.5, False, torch.device('cpu'), time.perf_counter(), small);"
            "print(harness.loaded_forbidden());"
            "print('uit_mobile_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]
