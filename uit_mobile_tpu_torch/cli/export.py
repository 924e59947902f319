"""Export a checkpoint: reference-torch state_dict or a serving artifact.

Counterpart of ``uit_mobile_tpu/cli/export.py``. Torch interop (loads into
the original PyTorch code with strict=True; frontend buffers are
regenerated there):

    python -m uit_mobile_tpu_torch.cli.export CKPT.npz -o model.pt

Deployable serving artifact (a ``torch.export`` program with the weights
inside, ckpt/artifact.py):

    python -m uit_mobile_tpu_torch.cli.export CKPT.npz --artifact -o model.uitx
        [--batch-size N]        fixed batch (default: batch-polymorphic)
        [--dtype int16|float32] input contract (default float32)
        [--precision exact|fast]
        [--device cuda|cpu]     where the program runs (default cuda)
        [--kernel]              the fused mel kernel in the program (needs --batch-size)
        [--seconds S]           clip length (default 1.0 = 16000 samples)
        [--verify]              reload the artifact and check probs match
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _export_torch(args):
    import numpy as np
    import torch

    from ..ckpt.torch_convert import uit_torch_state_dict_from_params
    from .common import resolve_params

    if "," in args.checkpoint:
        raise SystemExit(
            "torch export needs ONE weight set: a comma ensemble spec has no single "
            "state_dict. Average the members first (python -m "
            "uit_mobile_tpu_torch.cli.average a.npz b.npz -o avg.npz) or export "
            "--artifact (the artifact holds the ensemble program).")
    cfg, params, state, _ = resolve_params(args.checkpoint)
    sd = uit_torch_state_dict_from_params(params, state, cfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, Path(args.output))
    print(args.output)
    return 0


def _export_artifact(args):
    import numpy as np
    import torch

    from ..ckpt.artifact import export_serving, load_artifact, save_artifact
    from .common import load_label_map, resolve_model

    # resolve_model accepts every spec form, the comma ensemble included:
    # export_serving builds through make_forward_fn's policy, which turns a
    # list of members into one prob-averaging program
    cfg, model = resolve_model(args.checkpoint, device="cpu")
    n_samples = int(round(args.seconds * 16000))
    exported = export_serving(cfg, model, batch_size=args.batch_size, n_samples=n_samples,
                              dtype=args.dtype, precision=args.precision,
                              use_kernel=args.kernel, device=args.device)
    try:
        labels = {str(k): v for k, v in load_label_map().items()}
    except OSError:
        labels = None
    out = save_artifact(args.output, exported, cfg=cfg, labels=labels)
    if args.verify:
        from ..ops.pipeline import make_forward_fn

        fn, _meta = load_artifact(out, device=args.device)
        b = args.batch_size or 2
        rng = np.random.default_rng(0)
        if args.dtype == "int16":
            wav = rng.integers(-2000, 2000, (b, n_samples), dtype=np.int16)
        else:
            wav = (rng.standard_normal((b, n_samples)) * 0.1).astype(np.float32)
        members = model if isinstance(model, list) else [model]
        members = [m.to(fn.device) for m in members]
        ref = make_forward_fn(cfg, members if len(members) > 1 else members[0],
                              use_kernel=args.kernel, precision=args.precision,
                              top_db_mode="per_sample")(torch.from_numpy(wav))
        drift = float((fn(wav) - ref).abs().max())
        # the repo-wide prob-drift budget
        if not drift <= 1e-3:
            raise SystemExit(f"artifact drift {drift} > 1e-3")
        print(f"verified: max prob drift {drift:.2e} at B={b}", file=sys.stderr)
    print(out)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="uit-export-torch")
    parser.add_argument("checkpoint")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--artifact", action="store_true",
                        help="emit a .uitx serving artifact instead of a torch state_dict")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="fix the batch dim (default: polymorphic)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "int16"])
    parser.add_argument("--precision", default="exact", choices=["exact", "fast"])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--kernel", action="store_true",
                        help="the fused mel kernel in the program (needs --batch-size)")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--verify", action="store_true")
    args = parser.parse_args(argv)
    if args.artifact:
        return _export_artifact(args)
    return _export_torch(args)


if __name__ == "__main__":
    sys.exit(main())
