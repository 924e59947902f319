"""The control of each cell on the card, at a size a test run holds: the
reference with TF32 on in the program's place fails the cell's limit on
one of its numbers at least (the training cell: and half a batch left out
fails one, and the program's fast mel fails the mel's gap). Marked
``gpu``; skips without a card. On the card:

    python -m pytest --noconftest -m gpu bench_port/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

SMALL = {
    "uit_xs_moe.train.as10": dict(batch=8, host_batches=4),
}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card has")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits(name, card):
    cell = harness.load_cell(name)
    limits = cell.traffic["limits"]
    out = harness.driver(cell).control(harness.Context(cell, 3_000_000_019, card, SMALL[name]))
    readings = out.get("tf32", out)
    assert any(readings[k] > limits[k] for k in readings if k in limits), (readings, limits)
    if "half_batch" in out:
        assert any(v > limits[k] for k, v in out["half_batch"].items() if k in limits), out
    if "mel_fast" in out:  # the program's own lower precision of the mel
        assert out["mel_fast"]["mel_gap_db"] > limits["mel_gap_db"], out
