"""Training CLI, counterpart of ``uit_mobile_tpu/cli/train.py``.

    python -m uit_mobile_tpu_torch.cli.train train configs/train_uit_xs.yaml [--key value ...]
    python -m uit_mobile_tpu_torch.cli.train run   configs/train_uit_xs.yaml   # train + eval
    python -m uit_mobile_tpu_torch.cli.train sed   configs/train_sed.yaml
    python -m uit_mobile_tpu_torch.cli.train pretrain configs/pretrain_mae.yaml
    python -m uit_mobile_tpu_torch.cli.train train cfg.yaml --device cpu

Any ``--key value`` pair overrides the YAML config. Training runs on the
card unless ``--device cpu`` asks for the CPU. ``run`` trains, then
evaluates the deliverable with the Evaluator: GSC on ``kws_test_data`` and
AudioSet on ``audioset_eval_data``. ``sed`` trains strong-label framewise
(train/sed.py) and prints best_sed.npz; ``pretrain`` runs MAE pretraining
(train/pretrain.py) and prints mae_pretrained.npz.
"""

from __future__ import annotations

import argparse
import sys

from ..utils import parse_config_or_kwargs, parse_override

def _parse_overrides(pairs) -> dict:
    out, key = {}, None
    for tok in pairs:
        if tok.startswith("--"):
            key = tok[2:].replace("-", "_")
            out[key] = True  # bare flag
        else:
            if key is None:
                raise ValueError(f"value {tok!r} without --key")
            out[key] = parse_override(tok)
            key = None
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="uit-train-torch")
    parser.add_argument("command", choices=["train", "run", "pretrain", "sed"])
    parser.add_argument("config")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = parser.parse_known_args(argv)
    config = parse_config_or_kwargs(args.config, **_parse_overrides(rest))
    if args.command == "pretrain":
        from ..train.pretrain import pretrain_from_config

        print(pretrain_from_config(config, device=args.device))
        return 0
    if args.command == "sed":
        from ..train.sed import train_sed_from_config

        print(train_sed_from_config(config, device=args.device))
        return 0
    from ..train.loop import train_from_config

    output_model = train_from_config(config, device=args.device)
    if args.command == "run":
        from ..evaluate import Evaluator

        evaluate_run(Evaluator(str(output_model), device=args.device), config)
    print(output_model)
    return 0


def evaluate_run(evaluator, config: dict) -> dict:
    """``run``'s evaluation of the trained deliverable: GSC on the config's
    ``kws_test_data``, then AudioSet on its ``audioset_eval_data``."""
    return {"gsc": evaluator.gsc(eval_data=config["kws_test_data"]),
            "audioset": evaluator.audioset(audioset_eval_data=config["audioset_eval_data"])}


if __name__ == "__main__":
    sys.exit(main())
