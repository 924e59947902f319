"""The port's inference CLI vs the JAX CLI on samples/*.wav with one npz."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WAVS = sorted(str(p.relative_to(REPO)) for p in (REPO / "samples").glob("*.wav"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = jax_models.get_model_config("uit_xxxs", outputdim=537, target_length=102)
    params, state = jax_models.build(cfg, jax.random.key(0))
    path = tmp_path_factory.mktemp("ckpt") / "demo.npz"
    jax_save(path, params, state, cfg)
    return path


def _rows(out: str):
    """-> [(file header or (label, prob))] parsed from the printed ranking."""
    rows = []
    for line in out.splitlines():
        if line.startswith("====="):
            rows.append(line.strip("= ").strip())
        elif line.strip():
            name, prob = line.rsplit(None, 1)
            rows.append((name.strip(), float(prob)))
    return rows


def _run(main, argv, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    assert main(argv) == 0
    return _rows(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--batched"], ["--kernel"]])
def test_cli_matches_jax_cli(ckpt, capsys, monkeypatch, extra):
    from uit_mobile_tpu.cli.infer import main as jax_main
    from uit_mobile_tpu_torch.cli.infer import main as port_main

    jax_args = [a for a in extra if a != "--kernel"]
    want = _run(jax_main, [*WAVS, "-m", str(ckpt), "-k", "5", *jax_args], capsys, monkeypatch)
    got = _run(port_main, [*WAVS, "-m", str(ckpt), "-k", "5", "--device", "cpu", *extra],
               capsys, monkeypatch)
    assert len(got) == len(want) == len(WAVS) * 6
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            assert g[0] == w[0]  # same label, same rank
            assert abs(g[1] - w[1]) <= 1e-4


def test_cli_refusals(ckpt, tmp_path, monkeypatch):
    from uit_mobile_tpu_torch.cli.infer import main
    from uit_mobile_tpu_torch.data import write_wav

    monkeypatch.chdir(REPO)
    with pytest.raises(ValueError, match=">=2 checkpoints"):
        main([WAVS[0], "-m", f"{ckpt},", "--device", "cpu", "--events"])
    with pytest.raises(FileNotFoundError, match="model.pt does not exist"):
        main([WAVS[0], "-m", "model.pt", "--device", "cpu"])
    p = tmp_path / "sr8k.wav"
    write_wav(p, np.zeros(8000, np.float32), sample_rate=8000)
    with pytest.raises(ValueError, match="16khz"):
        main([str(p), "-m", str(ckpt), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main([WAVS[0], "-m", str(ckpt)])
