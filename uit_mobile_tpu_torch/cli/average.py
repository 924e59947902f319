"""Checkpoint averaging CLI, counterpart of ``uit_mobile_tpu/cli/average.py``.

    python -m uit_mobile_tpu_torch.cli.average CKPT1.npz CKPT2.npz ... -o OUT.npz
    python -m uit_mobile_tpu_torch.cli.average exp_dir -o OUT.npz      # best_*.npz
    python -m uit_mobile_tpu_torch.cli.average ... -o OUT.pt           # torch export
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="uit-average-torch")
    parser.add_argument("models", nargs="+",
                        help="checkpoints (.npz) or one experiment directory")
    parser.add_argument("-o", "--output", required=True,
                        help="output model (.npz native, .pt torch export)")
    args = parser.parse_args(argv)

    from ..ckpt.io import average_checkpoints, save_numpy_checkpoint

    paths = [Path(m) for m in args.models]
    if len(paths) == 1 and paths[0].is_dir():
        paths = sorted(paths[0].glob("best_*.npz")) or sorted(paths[0].glob("*.npz"))
    if not paths:
        raise SystemExit("no checkpoints found")
    params, state, cfg, extra = average_checkpoints(paths)

    out = Path(args.output)
    if out.suffix == ".pt":
        import numpy as np
        import torch

        from ..ckpt.torch_convert import uit_torch_state_dict_from_params

        sd = uit_torch_state_dict_from_params(params, state, cfg)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out)
    else:
        save_numpy_checkpoint(out, params, state, cfg,
                              extra={"averaged_from": [str(p) for p in paths]})
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
