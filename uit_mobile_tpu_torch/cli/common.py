"""Shared CLI helpers: label maps and checkpoint resolution (local files only,
comma-joined ensembles, reference ``.pt`` dumps converted on load)."""

from __future__ import annotations

import csv
import re
from pathlib import Path
from urllib.parse import urlparse

from .. import models
from ..ckpt.convert import module_from_numpy
from ..ckpt.dcp_io import is_dcp_dir, load_dcp
from ..ckpt.io import load_checkpoint
from ..models import PRETRAINED_CHECKPOINTS
from ..utils import get_logger

log = get_logger()

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


def infer_uit_config_from_state_dict(sd: dict, **overrides):
    """A UITConfig from a raw reference state_dict's shapes: embed_dim,
    depth, attention type, outputdim, mlp_ratio, init_bn and patch size.
    num_heads, act and pooling leave no trace in the shapes: they default
    to the published uit_* dumps' (2, relu, mean) with a warning unless
    given. target_length is 102 for a 6-patch grid, 1012 for 63 (the
    reference's two), else 16 x the grid with a warning."""
    D = sd["patch_embed.proj.weight"].shape[0]
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    attention_type = ("BNeckAttention" if sd["blocks.0.attn.qkv.weight"].shape[0] < 3 * D
                      else "Attention")
    tg = sd["time_pos_embed"].shape[-1]
    target_length = {6: 102, 63: 1012}.get(tg)
    if target_length is None:
        target_length = tg * 16
        log.warning(f"inferred target_length={target_length} from grid size {tg}; the true "
                    "value may be up to 15 frames larger — pass target_length explicitly "
                    "if long-clip windows matter")
    kwargs = dict(outputdim=sd["outputlayer.1.weight"].shape[0], embed_dim=D, depth=depth,
                  num_heads=2, mlp_ratio=sd["blocks.0.mlp.fc1.weight"].shape[0] / D,
                  pooling="mean", act="relu", attention_type=attention_type,
                  init_bn="init_bn.1.weight" in sd, target_length=target_length,
                  patch_size=sd["patch_embed.proj.weight"].shape[-1])
    unverifiable = [k for k in ("act", "num_heads", "pooling") if k not in overrides]
    if unverifiable:
        log.warning("raw state_dict carries no architecture record; assuming "
                    + ", ".join(f"{k}={kwargs[k]!r}" for k in unverifiable)
                    + " (correct for the published uit_xs/xxs/xxxs dumps); for the gelu "
                    "audio_transformer_h128_* family pass act/num_heads/pooling explicitly")
    kwargs.update(overrides)
    return models.UITConfig(**kwargs)


def _convert_torch_dump(path, **cfg_overrides):
    """A reference ``.pt`` (raw state_dict or trainer dump) -> (cfg, params,
    state, extra): a trainer dump's embedded config names the model, a raw
    state_dict's shapes give it (infer_uit_config_from_state_dict)."""
    from ..ckpt.torch_convert import load_torch_checkpoint, uit_params_from_torch_state_dict

    dump = load_torch_checkpoint(path)
    extra = {}
    if dump["config"]:
        c = dump["config"]
        cfg = models.get_model_config(c["model"], outputdim=c.get("num_classes", 537),
                                      **c.get("model_args", {}))
        extra["run_config"] = c
    else:
        cfg = infer_uit_config_from_state_dict(dump["state_dict"], **cfg_overrides)
    params, state = uit_params_from_torch_state_dict(dump["state_dict"], cfg)
    return cfg, params, state, extra


def _pick_checkpoint_in_dir(p: Path) -> Path:
    """The deliverable of an experiment directory: averaged.npz, else the
    best_* npz with the highest mAP in its name, else averaged.pt, else the
    best*.pt with the highest mAP, else any npz, else any pt."""
    if (p / "averaged.npz").exists():
        return p / "averaged.npz"
    best = sorted(p.glob("best_*.npz"), key=_best_score_in_name)
    if best:
        return best[-1]
    if (p / "averaged.pt").exists():
        return p / "averaged.pt"
    best_pt = sorted(p.glob("best*.pt"), key=_best_score_in_name)
    if best_pt:
        return best_pt[-1]
    for pattern in ("*.npz", "*.pt"):
        hits = sorted(p.glob(pattern))
        if hits:
            return hits[0]
    raise FileNotFoundError(f"no checkpoint found under {p}")


def resolve_params(spec: str, **cfg_overrides):
    """Resolve one model spec -> (cfg, params, state, extra), JAX-layout
    numpy trees: a local pretrained name (``checkpoints/<name>.npz``, else
    ``checkpoints/<name>*.pt``), a URL whose file name lies under
    ``checkpoints/`` (nothing is downloaded), a native ``.npz``, a
    reference ``.pt`` (converted), a DCP checkpoint directory
    (``ckpt/dcp_io.py``), or an experiment directory."""
    ckpt_dir = REPO_ROOT / "checkpoints"
    if spec.startswith(("http://", "https://")):
        local = ckpt_dir / Path(urlparse(spec).path).name
        if not local.exists():
            raise FileNotFoundError(
                f"the port never downloads; place the file at {local} to use {spec!r}")
        log.info(f"using local copy {local} for {spec}")
        return resolve_params(str(local), **cfg_overrides)
    if spec in PRETRAINED_CHECKPOINTS:
        entry = PRETRAINED_CHECKPOINTS[spec]
        if entry["path"].exists():
            params, state, cfg, extra = load_checkpoint(entry["path"])
            return cfg or entry["factory"](**entry["model_kwargs"]), params, state, extra
        hits = sorted(ckpt_dir.glob(f"{spec}*.pt")) if ckpt_dir.exists() else []
        if hits:
            return _convert_torch_dump(hits[0], **cfg_overrides)
        raise FileNotFoundError(
            f"no local checkpoint for {spec!r}: the port never downloads; place the "
            f"reference dump at {ckpt_dir / (spec + '.pt')} or a converted npz at "
            f"{entry['path']}")
    p = Path(spec)
    if p.is_dir():
        if is_dcp_dir(p):
            params, state, cfg, extra = load_dcp(p)
            if cfg is None:
                raise ValueError(f"DCP checkpoint {p} has no embedded config")
            return cfg, params, state, extra
        p = _pick_checkpoint_in_dir(p)
    if p.suffix == ".npz":
        params, state, cfg, extra = load_checkpoint(p)
        if cfg is None:
            raise ValueError(f"{p} has no embedded config")
        return cfg, params, state, extra
    if p.suffix == ".pt":
        if not p.exists():
            raise FileNotFoundError(f"torch checkpoint {p} does not exist")
        return _convert_torch_dump(p, **cfg_overrides)
    raise ValueError(f"cannot resolve model spec {spec!r}")


def resolve_model(spec: str, device="cuda", return_extra: bool = False):
    """Resolve a model spec -> (cfg, model on ``device``) [+ extra dict].

    Accepted specs: those of ``resolve_params`` (a local pretrained name,
    a URL with a local copy, ``.npz``, reference ``.pt``, an experiment
    directory), or two or more of them joined by commas: an ensemble,
    whose members must share one config exactly; it resolves to (cfg,
    [models]) and every forward built through ``ops.pipeline`` averages
    the members' probabilities.

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
    cfg, params, state, extra = resolve_params(spec)
    return cfg, module_from_numpy(cfg, params, state, device), extra
