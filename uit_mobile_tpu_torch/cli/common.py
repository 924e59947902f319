"""Shared CLI helpers: label maps and checkpoint resolution (local files only)."""

from __future__ import annotations

import csv
import re
from pathlib import Path

from ..ckpt.io import load_model
from ..models import PRETRAINED_CHECKPOINTS

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
# the 538-row merged AudioSet+keywords index ships as package data; the
# repo-level datasets/ copy is used if present (both are identical)
LABEL_CSV = Path(__file__).resolve().parent.parent / "data" / "merged_class_label_indices.csv"


def load_label_map(path=None) -> dict[int, str]:
    if path is None:
        repo_csv = REPO_ROOT / "datasets" / "merged_class_label_indices.csv"
        path = repo_csv if repo_csv.exists() else LABEL_CSV
    with open(path) as f:
        return {int(r["index"]): r["display_name"] for r in csv.DictReader(f)}


def _best_score_in_name(path: Path) -> float:
    """The trainer's ``best_model_<step>_mAP=<score>`` score, else -inf."""
    m = re.search(r"mAP=([0-9.]+)", path.name)
    if m:
        try:
            return float(m.group(1).rstrip("."))
        except ValueError:
            pass
    return float("-inf")


def _pick_checkpoint_in_dir(p: Path) -> Path:
    """The deliverable npz of an experiment directory: averaged.npz, else the
    best_* file with the highest mAP in its name, else any npz."""
    if (p / "averaged.npz").exists():
        return p / "averaged.npz"
    best = sorted(p.glob("best_*.npz"), key=_best_score_in_name)
    if best:
        return best[-1]
    hits = sorted(p.glob("*.npz"))
    if hits:
        return hits[0]
    if any(p.glob("*.pt")):
        raise NotImplementedError(
            f"{p} holds only torch .pt dumps; their conversion is not yet ported "
            f"(convert with the JAX package's ckpt.torch_convert and save an npz)")
    raise FileNotFoundError(f"no checkpoint found under {p}")


def resolve_model(spec: str, device="cuda"):
    """Resolve a model spec -> (cfg, model on ``device``).

    Accepted specs: a local pretrained name (``checkpoints/<name>.npz`` in
    the repo; nothing is downloaded), a native ``.npz`` path, or an
    experiment directory. ``.pt`` dumps and comma-joined ensembles are not
    yet ported and raise."""
    if "," in spec:
        raise NotImplementedError("checkpoint ensembles are not yet ported")
    if spec.startswith(("http://", "https://")):
        raise FileNotFoundError(
            f"the port never downloads; place the file under {REPO_ROOT / 'checkpoints'}"
            f" and pass its path instead of {spec!r}")
    p = Path(spec)
    if spec in PRETRAINED_CHECKPOINTS:
        entry = PRETRAINED_CHECKPOINTS[spec]
        if not entry["path"].exists():
            raise FileNotFoundError(
                f"no local checkpoint for {spec!r}: place a converted npz at "
                f"{entry['path']}")
        cfg, model, _ = load_model(entry["path"], device,
                                   cfg=entry["factory"](**entry["model_kwargs"]))
        return cfg, model
    if p.is_dir():
        p = _pick_checkpoint_in_dir(p)
    if p.suffix == ".pt":
        raise NotImplementedError(
            f"converting the torch dump {p} is not yet ported (convert with the "
            f"JAX package's ckpt.torch_convert and save an npz)")
    if p.suffix == ".npz":
        cfg, model, _ = load_model(p, device)
        return cfg, model
    raise ValueError(f"cannot resolve model spec {spec!r}")
