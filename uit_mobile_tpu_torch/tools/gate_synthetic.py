"""The synthetic accuracy gate, counterpart of ``tools/gate_synthetic.py``:
train on the deterministic synthetic keyword world and evaluate through the
port's real CLIs, and fail when a score misses its pinned minimum.

    python -m uit_mobile_tpu_torch.tools.gate_synthetic            # full size, the card
    python -m uit_mobile_tpu_torch.tools.gate_synthetic --small --device cpu

1. ``data/synthworld.py:build_world(store="npz")``: TSV manifests over
   ``.npz`` stores (no h5py);
2. ``cli.train.main(["train", cfg])``: uit_xxxs at full width;
3. ``cli.evaluate.main(["audioset", model, "--audioset-eval-data",
   kws_eval])`` -> mAPKWS (chance ~0.1);
4. ``cli.evaluate.main(["gsc", model, "--eval-data", mixed])`` ->
   Accuracy@0.2 on the keywords-plus-fillers split, so both branches of the
   GSC protocol run.

The CLIs run in this process, each with the mel kernel's launch counts
(``ops/mel.py:launches``) set to 0 just before it and read just after. The
last line printed is one JSON object with both scores, their minimums, the
training wall time and those counts. Exit 0 = both minimums met, 1 = a
score below its minimum, anything else = a crash.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import re
import sys
import tempfile
import time
from pathlib import Path

# the JAX gate's pinned minimums (tools/gate_synthetic.py:70-71)
MIN_MAPKWS = 0.80
MIN_GSC_ACCURACY = 0.80


def _score(printed: str, name: str) -> float:
    """A metric from a CLI's printed results dict (a float or np.float64)."""
    m = re.search(rf"'{re.escape(name)}':\s*(?:np\.float\d*\()?([0-9.eE+-]+)", printed)
    if m is None:
        raise RuntimeError(f"no {name} in the CLI's output:\n{printed}")
    return float(m.group(1))


def _run(main, argv: list) -> tuple:
    """main(argv) with the launch counts from 0 -> (its stdout, the counts)."""
    from ..ops.mel import launches

    for k in launches:
        launches[k] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"{argv[0]} CLI exited {rc}")
    return buf.getvalue(), dict(launches)


def _concat_tsv(paths: list, out: Path) -> None:
    """Manifests with one header -> one manifest (the first's header)."""
    lines = []
    for i, path in enumerate(paths):
        rows = Path(path).read_text().splitlines()
        lines += rows if i == 0 else rows[1:]
    out.write_text("\n".join(lines) + "\n")


def run_gate(outdir=None, *, small: bool = False, device: str = "cuda",
             quiet: bool = False) -> dict:
    """World -> train (cli.train) -> evaluate (cli.evaluate audioset, gsc)
    -> the readings, with ``passed`` true when both scores meet their
    minimums. The world (seed 0) and the recipe are the JAX gate's:
    uit_xxxs, batch 32, 40 iterations an epoch, 10 epochs (4 with
    ``small``, and 192 training clips for 256), 40 warmup iterations, AdamW
    at lr 7e-4, and the keyword classes' BCE weighted 40 (keyword positives
    are ~5 % of the rows; unweighted, their probabilities stay under the
    GSC protocol's 0.2 threshold)."""
    from ..cli import evaluate as eval_cli
    from ..cli import train as train_cli
    from ..data.synthworld import build_world
    from ..utils import get_logger

    console = [h for h in get_logger().handlers if type(h) is logging.StreamHandler]
    levels = [h.level for h in console]
    out = Path(outdir or tempfile.mkdtemp(prefix="uit_gate_"))
    out.mkdir(parents=True, exist_ok=True)
    n_train, epochs = (192, 4) if small else (256, 10)
    world = build_world(out / "world", seed=0, n_train=n_train, n_eval=64, store="npz")
    config = dict(
        outputpath=str(out / "exp"), num_classes=537, model="uit_xxxs",
        model_args={"target_length": 102, "init_bn": False},
        batch_size=32, epochs=epochs, epoch_length=40, warmup_iters=40, chunk_length=1.0,
        optimizer="AdamW", optimizer_args={"lr": 7e-4, "weight_decay": 1e-8},
        loss="BCELoss", loss_args={"weight": [1.0] * 527 + [40.0] * 10},
        early_stop=epochs, n_saved=2, num_workers=2, seed=0, config_stem="gate", **world)
    cfg = out / "gate.yaml"
    cfg.write_text(json.dumps(config))  # JSON is YAML
    dev = ["--device", device]
    gsc_tsv = out / "gsc_eval.tsv"
    _concat_tsv([world["kws_test_data"], world["audioset_eval_data"]], gsc_tsv)
    try:
        for h in console if quiet else ():
            h.setLevel(logging.WARNING)
        t0 = time.perf_counter()
        printed, train_launches = _run(train_cli.main, ["train", str(cfg), *dev])
        train_s = time.perf_counter() - t0
        model_path = printed.strip().splitlines()[-1]
        t0 = time.perf_counter()
        as_out, as_launches = _run(eval_cli.main, [
            "audioset", model_path, "--audioset-eval-data", world["kws_test_data"], *dev])
        gsc_out, gsc_launches = _run(eval_cli.main, [
            "gsc", model_path, "--eval-data", str(gsc_tsv), *dev])
        eval_s = time.perf_counter() - t0
    finally:
        for h, level in zip(console, levels):
            h.setLevel(level)
    if not quiet:
        print(as_out + gsc_out, end="")
    rec = {"gate": "synthetic", "small": small, "device": device, "checkpoint": model_path,
           "mAPKWS": _score(as_out, "mAPKWS"), "min_mAPKWS": MIN_MAPKWS,
           "gsc_accuracy@0.2": _score(gsc_out, "Accuracy@0.2"),
           "min_gsc_accuracy@0.2": MIN_GSC_ACCURACY,
           "gsc_eval_rows": len(gsc_tsv.read_text().splitlines()) - 1,
           "train_wall_s": train_s, "evaluate_wall_s": eval_s,
           "mel_launches": {"train": train_launches, "evaluate_audioset": as_launches,
                            "evaluate_gsc": gsc_launches}}
    rec["passed"] = (rec["mAPKWS"] >= MIN_MAPKWS
                     and rec["gsc_accuracy@0.2"] >= MIN_GSC_ACCURACY)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="uit-gate-torch")
    ap.add_argument("--outdir", default=None, help="the world, config and run (a temp dir)")
    ap.add_argument("--small", action="store_true",
                    help="the CPU-sized world and schedule (192 clips, 4 epochs)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rec = run_gate(args.outdir, small=args.small, device=args.device)
    for name, key in (("mAPKWS", "mAPKWS"), ("GSC Accuracy@0.2", "gsc_accuracy@0.2")):
        ok = rec[key] >= rec[f"min_{key}"]
        print(f"[gate_synthetic] {name}={rec[key]:.4f} min={rec[f'min_{key}']} -> "
              f"{'PASS' if ok else 'FAIL'}")
    print(f"[gate_synthetic] train {rec['train_wall_s']:.1f} s on {args.device}; "
          f"mel kernel launches {rec['mel_launches']}")
    print(json.dumps(rec), flush=True)
    return 0 if rec["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
