"""The port's synthetic accuracy gate (uit_mobile_tpu_torch.tools.
gate_synthetic), the counterpart of tests/test_synth_gate.py, held to the
JAX gate: the same world (the port's .npz store against JAX's HDF5, clip
for clip) and the same config, key for key; then the real train and
evaluate CLIs at the CPU size, pinned at mAPKWS >= 0.80 and GSC
Accuracy@0.2 >= 0.80. The gate's training is marked slow as the JAX test
is, so Tier-1 does not run it; the world's pin takes about a second and
runs in Tier-1."""

import json
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from uit_mobile_tpu_torch.data.synthworld import KW_FREQS, build_world

REPO = Path(__file__).resolve().parent.parent
COLUMNS = ["filename", "labels", "hdf5path"]


def _store(path: Path) -> dict:
    """{key: PCM bytes} of an .npz store or an HDF5 file."""
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: (z[k].dtype.str, z[k].tobytes()) for k in z.files}
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype.str, f[k][...].tobytes()) for k in f}


def _rows(tsv: str, store: str) -> list:
    """A manifest's rows with the store path checked (the split's own
    store, next to the TSV) and dropped."""
    header, *lines = Path(tsv).read_text().splitlines()
    assert header.split("\t") == COLUMNS, header
    rows = [line.split("\t") for line in lines]
    assert {r[2] for r in rows} == {str(Path(tsv).with_suffix(store))}, tsv
    return [r[:2] for r in rows]


def _assert_same_world(port: dict, jax: dict) -> None:
    """The port's .npz world equals JAX's HDF5 world: the same splits, each
    with the same keys, PCM (dtype and bytes) and TSV rows in order."""
    assert port.keys() == jax.keys()
    for split in port:
        assert _rows(port[split], ".npz") == _rows(jax[split], ".h5"), split
        p = _store(Path(port[split]).with_suffix(".npz"))
        j = _store(Path(jax[split]).with_suffix(".h5"))
        assert sorted(p) == sorted(j) and all(p[k] == j[k] for k in j), split


def test_npz_world_is_deterministic(tmp_path, monkeypatch):
    """build_world(store="npz"), built with h5py and pandas blocked, is the
    JAX package's build_world for each seed (so it is deterministic in the
    seed wherever JAX's is), and another seed gives another world."""
    from uit_mobile_tpu.data.synthworld import build_world as jax_build_world

    jax = {s: jax_build_world(tmp_path / f"jax{s}", seed=s, n_train=8, n_eval=4)
           for s in (0, 1)}
    with monkeypatch.context() as m:
        for name in ("h5py", "pandas"):
            m.setitem(sys.modules, name, None)
        port = {s: build_world(tmp_path / f"port{s}", seed=s, n_train=8, n_eval=4, store="npz")
                for s in (0, 1)}
    for s in (0, 1):
        _assert_same_world(port[s], jax[s])
    for split in port[0]:
        a, b = (_store(Path(port[s][split]).with_suffix(".npz")) for s in (0, 1))
        assert a != b, split
    assert len(KW_FREQS) == 10 and min(KW_FREQS) == 527


def _jax_gate_config(out: Path, monkeypatch) -> dict:
    """The JAX gate's config and world at --small: its run_gate up to the
    train CLI, which is stopped there."""
    import uit_mobile_tpu.cli.train as jax_train
    import yaml
    from tools.gate_synthetic import run_gate as jax_run_gate

    class Stop(Exception):
        pass

    def stop(argv):
        raise Stop(argv)

    with monkeypatch.context() as m:
        m.setattr(jax_train, "main", stop)
        with pytest.raises(Stop):
            jax_run_gate(out, small=True, quiet=True)
    return yaml.safe_load((out / "gate.yaml").read_text())


def _relative(config: dict, root: Path) -> dict:
    """A config with its paths under ``root`` written relative to it."""
    return {k: v.replace(str(root), "<out>") if isinstance(v, str) else v
            for k, v in config.items()}


@pytest.mark.slow
def test_gate_passes_on_cpu(tmp_path, monkeypatch):
    """The whole gate on the CPU at --small, in a process with h5py
    blocked (pandas stays: the Trainer's and evaluator's manifests are
    DataFrames, as in the JAX package): its config equals the JAX gate's
    key for key and its world JAX's clip for clip, and both minimums are
    met (run_gate returns its readings whether or not a score misses, so
    the minimums are asserted here)."""
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    code = (
        "import json, sys\n"
        "sys.modules['h5py'] = None\n"
        "from uit_mobile_tpu_torch.tools.gate_synthetic import run_gate\n"
        f"print(json.dumps(run_gate({str(port_out)!r}, small=True, device='cpu', quiet=True)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])

    port_config = json.loads((port_out / "gate.yaml").read_text())
    jax_config = _jax_gate_config(jax_out, monkeypatch)
    assert _relative(port_config, port_out) == _relative(jax_config, jax_out)
    world = ("audioset_train_data", "audioset_eval_data", "kws_train_data", "kws_test_data")
    _assert_same_world({k: port_config[k] for k in world}, {k: jax_config[k] for k in world})

    assert rec["mAPKWS"] >= 0.80 and rec["gsc_accuracy@0.2"] >= 0.80 and rec["passed"], rec
    assert rec["gsc_eval_rows"] == 128 and rec["device"] == "cpu"
