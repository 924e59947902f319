"""Each cell's driver on the CPU at a small size: the program against the plain
reference (correct), and the timed path broken underneath (not correct):
a step that leaves its state unchanged, a step that leaves half of its
batch out."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

SMALL = {
    "uit_xs_moe.train.as10": dict(depth=1, batch=8, clip_seconds=1.0, host_batches=4,
                                  scene_seconds=20),
}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0):
    cell = harness.load_cell(name)
    record, checks = harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                                      time.perf_counter(), small=SMALL[name])
    return harness.result_line(cell, record, checks, False, {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_program_matches_the_reference(name):
    line = run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from uit_mobile_tpu_torch.train import steps

    monkeypatch.setattr(steps.Optimizer, "device_update", lambda self, *a, **k: None)
    line = run("uit_xs_moe.train.as10")
    # the median leaf's gap: 1 on the leaves at or above the median norm
    assert not line["correct"] and line["checks"]["change_gap"]["value"] > 0.3


def test_a_step_on_half_its_batch_is_not_correct(monkeypatch):
    from uit_mobile_tpu_torch.train import steps

    make_loss = steps.make_loss

    def half(name, **kw):
        loss = make_loss(name, **kw)
        return lambda p, t: loss(p[: p.shape[0] // 2], t[: t.shape[0] // 2])

    monkeypatch.setattr(steps, "make_loss", half)
    line = run("uit_xs_moe.train.as10")
    assert not line["correct"]
