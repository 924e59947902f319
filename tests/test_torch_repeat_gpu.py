"""The recipe's Trainer repeats bitwise on the card: fresh ``cli.train``
processes on one config and seed end with one last.npz, bit for bit, and
log one state digest, at ``num_workers`` 1 and 2.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_repeat_gpu.py -q

The recipe is ``configs/train_uit_xs.yaml``'s as chip_smoke.py drives it
(uit_xs at full width and depth, B=32 1 s crops, its augments, AdamW, the
exact frontend, the untrained MobileNetV2 PSL teacher) for 2 epochs of 6
steps on a 64-clip synthworld; each process replays its step and
validation as CUDA graphs and launches ``row_exact``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch.data.synthworld import build_world

REPO = Path(__file__).resolve().parent.parent
RECIPE = {
    "model": "uit_xs", "model_args": {"target_length": 102}, "num_classes": 537,
    "optimizer": "AdamW", "optimizer_args": {"lr": 0.001, "weight_decay": 5e-8},
    "loss": "BCELoss", "batch_size": 32, "chunk_length": 1.0, "epochs": 2, "epoch_length": 6,
    "warmup_iters": 5, "early_stop": 50, "valid_every": 1, "n_saved": 2, "seed": 42,
    "frontend_precision": "exact",
    "psl": {"model": "MobileNetV2", "pretrained": "missing.npz", "allow_untrained": True},
    "wavtransforms": {"Shift": {"min_shift": -0.5, "max_shift": 0.5}, "Gain": {"p": 0.5},
                      "PolarityInversion": {"p": 0.5}},
    "spectransforms": [{"TimeMasking": {"time_mask_param": 20, "iid_masks": True}},
                       {"FrequencyMasking": {"freq_mask_param": 8, "iid_masks": True}},
                       {"FrequencyMasking": {"freq_mask_param": 8, "iid_masks": True}}],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the mel kernel has no CPU mode")


def arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


@pytest.mark.gpu
def test_recipe_repeats_bitwise_in_fresh_processes(tmp_path, cuda):
    cfg = tmp_path / "recipe.yaml"
    cfg.write_text(json.dumps(dict(RECIPE, **build_world(tmp_path / "world", seed=42,
                                                         n_train=64, n_eval=32,
                                                         store="npz"))))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {}
    for name, workers in (("first", 1), ("again", 1), ("workers_2", 2)):
        proc = subprocess.run([sys.executable, "-m", "uit_mobile_tpu_torch.cli.train", "train",
                               str(cfg), "--outputdir", str(tmp_path / name),
                               "--num_workers", str(workers)],
                              capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        log = (tmp_path / name / "train.log").read_text()
        runs[name] = (arrays(tmp_path / name / "last.npz"),
                      re.findall(r"state digest: (\w+)", log)[-1],
                      json.loads(re.findall(r"mel kernel launches: (\{.*\})", log)[-1]),
                      json.loads(re.findall(r"graph dispatch: (\{.*\})", log)[-1]))
    want, digest, launches, dispatch = runs["first"]
    print({name: (d, n["row_exact"]) for name, (_, d, n, _) in runs.items()})
    assert launches["row_exact"] > 0 and dispatch["step"]["replays"] > 0
    for name in ("again", "workers_2"):
        got, d, n, g = runs[name]
        assert got.keys() == want.keys()
        differ = [k for k in want if not np.array_equal(got[k], want[k])]
        assert not differ and d == digest, (name, differ[:3])
        assert n == launches and g == dispatch
