"""Shared CLI helpers: label maps and checkpoint resolution (local files only,
comma-joined ensembles)."""

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


def resolve_model(spec: str, device="cuda", return_extra: bool = False):
    """Resolve a model spec -> (cfg, model on ``device``) [+ extra dict].

    Accepted specs: a local pretrained name (``checkpoints/<name>.npz`` in
    the repo; nothing is downloaded), a native ``.npz`` path, an experiment
    directory, or two or more of these joined by commas: an ensemble, whose
    members must share one config exactly; it resolves to (cfg, [models])
    and every forward built through ``ops.pipeline`` averages the members'
    probabilities. ``.pt`` dumps are not yet ported and raise.

    With ``return_extra=True`` a third element is the checkpoint's sidecar
    metadata (the first member's for an ensemble, plus ``ensemble``: the
    member count): ``run_config`` holds the training config of a
    trainer-written checkpoint, whose ``basename`` flag evaluation reads."""
    if "," in spec:
        parts = [s.strip() for s in spec.split(",") if s.strip()]
        if len(parts) < 2:
            raise ValueError(f"ensemble spec needs >=2 checkpoints: {spec!r}")
        resolved = [_resolve_model(s, device) for s in parts]
        cfg0 = resolved[0][0]
        for part, (c, _, _) in zip(parts[1:], resolved[1:]):
            if c != cfg0:
                raise ValueError(f"ensemble members must share one model config: "
                                 f"{parts[0]!r} vs {part!r} differ ({cfg0} != {c})")
        out = (cfg0, [r[1] for r in resolved],
               {**(resolved[0][2] or {}), "ensemble": len(parts)})
    else:
        out = _resolve_model(spec, device)
    return out if return_extra else out[:2]


def _resolve_model(spec: str, device):
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
        return load_model(entry["path"], device,
                          cfg=entry["factory"](**entry["model_kwargs"]))
    if p.is_dir():
        p = _pick_checkpoint_in_dir(p)
    if p.suffix == ".pt":
        raise NotImplementedError(
            f"converting the torch dump {p} is not yet ported (convert with the "
            f"JAX package's ckpt.torch_convert and save an npz)")
    if p.suffix == ".npz":
        return load_model(p, device)
    raise ValueError(f"cannot resolve model spec {spec!r}")
