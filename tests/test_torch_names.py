"""The port's package-level names against the JAX package's: every name in
each JAX subpackage's ``__all__`` is exported by the port's subpackage of
the same name, or is in OMITTED, the port's omissions by design; and the
port's ``bce_loss`` against the JAX package's."""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu.train.steps import bce_loss as jax_bce_loss
from uit_mobile_tpu_torch.train import bce_loss

REPO = Path(__file__).resolve().parent.parent

# name -> why the port does not export it
OMITTED = {
    "TrainState": "the port's Optimizer holds the optimizer state; the step mutates "
                  "the model in place",
    "EmaState": "the port's Optimizer holds the parameter EMA (find_ema_params reads it)",
    "xla_cost": "XLA's cost analysis; utils/flops.py:counted_flops counts the aten ops",
    "xla_flops": "as xla_cost",
    "xla_bytes": "as xla_cost",
    "pallas_log_mel": "the TPU kernel; the port's is ops/mel.py:log_mel over csrc/mel.cu",
    "layer_norm_init": "the port's LayerNorm is a torch module that initializes itself",
    "CACHE_DIR": "the download cache; the port reads checkpoints/ and never downloads",
    "enable_compilation_cache": "JAX's persistent XLA cache; the port has no torch.compile, "
                                "and its persistent build is the kernel and native library "
                                "cache under uit_mobile_tpu_torch/_build/ (ops/build.py, "
                                "native/build.py), keyed on a source hash",
}


def _jax_all(init: Path) -> list:
    """The literal ``__all__`` of a JAX package's __init__.py, read without
    importing it."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def _jax_public(sub: str) -> list:
    """A JAX subpackage's public names: its ``__all__``, or where it has none
    (``native``) the public functions its __init__.py defines."""
    init = REPO / "uit_mobile_tpu" / sub / "__init__.py"
    return _jax_all(init) or [n.name for n in ast.parse(init.read_text()).body
                              if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


SUBPACKAGES = sorted({p.parent.name for p in (REPO / "uit_mobile_tpu").glob("*/__init__.py")
                      if _jax_all(p)} | {"native"})


def test_subpackages_listed():
    assert {"augment", "ckpt", "data", "evaluate", "frontend", "models", "native", "ops",
            "parallel", "serve", "train", "utils"} <= set(SUBPACKAGES)
    assert set(_jax_public("native")) == {"available", "parse_wav16_native", "read_wav_native",
                                          "pad_batch_native", "multihot_batch_native"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_exported_or_omitted_by_design(sub):
    port = importlib.import_module(f"uit_mobile_tpu_torch.{sub}")
    names = set(port.__all__)
    assert all(hasattr(port, n) for n in names)
    missing = [n for n in _jax_public(sub) if n not in names and n not in OMITTED]
    assert not missing, f"uit_mobile_tpu_torch.{sub} lacks {missing}"


def test_omissions_are_jax_names_the_port_lacks():
    """Each listed omission is a public name of the JAX package (a module's
    top level) that the port really does not export."""
    jax_names = set()
    for f in (REPO / "uit_mobile_tpu").rglob("*.py"):
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                jax_names.add(node.name)
            elif isinstance(node, ast.Assign):
                jax_names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    assert set(OMITTED) <= jax_names
    for sub in SUBPACKAGES:
        port = importlib.import_module(f"uit_mobile_tpu_torch.{sub}")
        assert not set(OMITTED) & set(port.__all__), sub


@pytest.mark.parametrize("eps", [1e-7, 1e-3])
def test_bce_loss_matches_jax(eps):
    """Seeded probabilities with exact 0s and 1s (where the eps clamp acts),
    soft and hard targets: 1e-6 relative."""
    rng = np.random.default_rng(0)
    probs = rng.uniform(0.0, 1.0, (8, 537)).astype(np.float32)
    probs[0, :40], probs[1, :40] = 0.0, 1.0
    targets = (rng.uniform(size=probs.shape) < 0.3).astype(np.float32)
    targets[2] = rng.uniform(size=537).astype(np.float32)
    targets[0, :20], targets[1, :20] = 1.0, 0.0  # the clamp sets these losses
    got = bce_loss(torch.from_numpy(probs), torch.from_numpy(targets), eps=eps).item()
    want = float(jax_bce_loss(jnp.asarray(probs), jnp.asarray(targets), eps=eps))
    assert got == pytest.approx(want, rel=1e-6)
