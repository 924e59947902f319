"""Evaluation CLI, counterpart of ``uit_mobile_tpu/cli/evaluate.py``, on the
card unless ``--device cpu``:

    python -m uit_mobile_tpu_torch.cli.evaluate audioset CKPT [--audioset-eval-data PATH]
    python -m uit_mobile_tpu_torch.cli.evaluate gsc CKPT [--eval-data PATH] [--pad]
    python -m uit_mobile_tpu_torch.cli.evaluate test_sample CKPT WAV
    python -m uit_mobile_tpu_torch.cli.evaluate strong CKPT [--sweep] [--psds]
    python -m uit_mobile_tpu_torch.cli.evaluate calibrate CKPT [-o cal.json]
    python -m uit_mobile_tpu_torch.cli.evaluate all CKPT --device cpu

CKPT is an npz, an experiment directory, a local pretrained name or a
comma-joined ensemble of these.
"""

from __future__ import annotations

import argparse
import sys

from ..evaluate import Evaluator


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="uit-evaluate-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_as = sub.add_parser("audioset")
    p_as.add_argument("experiment_path")
    p_as.add_argument("--audioset-eval-data", default="datasets/audioset/data/labels/eval.csv")
    p_as.add_argument("--batch-size", type=int, default=32)
    p_as.add_argument("--label-csv", default=None)
    p_as.add_argument("--dump-predictions", default=None, metavar="NPZ",
                      help="also write per-clip probs/targets/filenames to this .npz")

    p_gsc = sub.add_parser("gsc")
    p_gsc.add_argument("experiment_path")
    p_gsc.add_argument("--eval-data", default="datasets/gsc/data/labels/test_gsc_aslabels.tsv")
    p_gsc.add_argument("--threshold", type=float, default=0.2)
    p_gsc.add_argument("--batch-size", type=int, default=32)
    p_gsc.add_argument("--pad", action="store_true")
    p_gsc.add_argument("--sweep", action="store_true",
                       help="print the accuracy/FAR/FRR operating curve across thresholds")
    p_gsc.add_argument("--tie-mode", default="first", choices=["first", "reference"],
                       help="exact-float ties among AudioSet maxima: 'first' keeps the "
                            "first argmax, 'reference' the reference's equality mask")
    p_gsc.add_argument("--dump-predictions", default=None, metavar="NPZ",
                       help="also write per-clip probs/targets/filenames to this .npz")

    p_ts = sub.add_parser("test_sample")
    p_ts.add_argument("experiment_path")
    p_ts.add_argument("sample")
    p_ts.add_argument("--topk", type=int, default=5)

    p_strong = sub.add_parser(
        "strong", help="SED segment-F1 + event-F1 vs event-interval manifests")
    p_strong.add_argument("experiment_path")
    p_strong.add_argument("--eval-data", default="datasets/strong/eval.tsv")
    p_strong.add_argument("--threshold", type=float, default=0.5)
    p_strong.add_argument("--min-overlap", type=float, default=0.5)
    p_strong.add_argument("--median-kernel", type=int, default=1,
                          help="odd median-filter width (segments) before event extraction")
    p_strong.add_argument("--event-collar", type=float, default=0.2,
                          help="onset collar in seconds for event matching")
    p_strong.add_argument("--offset-collar-rate", type=float, default=0.2,
                          help="offset collar = max(collar, rate * event duration)")
    p_strong.add_argument("--min-duration", type=float, default=0.0,
                          help="drop extracted events shorter than this (s)")
    p_strong.add_argument("--merge-gap", type=float, default=0.0,
                          help="fuse events separated by gaps <= this (s)")
    p_strong.add_argument("--dump-events", default=None, metavar="TSV",
                          help="write extracted events (filename/event/onset/offset)")
    p_strong.add_argument("--criterion", default="collar", choices=["collar", "intersection"],
                          help="event matching: onset/offset collars or DTC/GTC ratios")
    p_strong.add_argument("--dtc", type=float, default=0.5,
                          help="min intersection/prediction ratio (--criterion intersection)")
    p_strong.add_argument("--gtc", type=float, default=0.5,
                          help="min intersection/reference ratio (--criterion intersection)")
    p_strong.add_argument("--cttc", type=float, default=None,
                          help="cross-trigger tolerance for --psds-alpha-ct (default 0.3)")
    p_strong.add_argument("--batch-size", type=int, default=32)
    p_strong.add_argument("--dtype", default="float32", choices=["float32", "int16"],
                          help="int16 moves batches as raw PCM (bitwise-identical results)")
    p_strong.add_argument("--sweep", nargs="*", type=float, default=None, metavar="T",
                          help="also score the event/segment operating curve at these "
                               "thresholds (a default sweep without values)")
    p_strong.add_argument("--psds", action="store_true",
                          help="PSDS over the sweep's operating points (implies a sweep)")
    p_strong.add_argument("--psds-alpha-st", type=float, default=0.0,
                          help="across-class std-dev penalty weight")
    p_strong.add_argument("--psds-alpha-ct", type=float, default=0.0,
                          help="cross-trigger penalty weight")
    p_strong.add_argument("--psds-e-max", type=float, default=100.0,
                          help="max effective FP rate (per hour) of the PSD-ROC integral")
    p_strong.add_argument("--thresholds", default=None, metavar="JSON",
                          help="per-class threshold file (from --thresholds-out); "
                               "overrides --threshold")
    p_strong.add_argument("--thresholds-out", default=None, metavar="JSON",
                          help="write the sweep's best per-class thresholds (implies a sweep)")

    p_cal = sub.add_parser("calibrate", help="fit temperature scaling on a held-out manifest")
    p_cal.add_argument("experiment_path")
    p_cal.add_argument("--eval-data", default="datasets/audioset/data/labels/eval.csv")
    p_cal.add_argument("--num-classes", type=int, default=None,
                       help="default: the checkpoint's own head width")
    p_cal.add_argument("--per-class", action="store_true",
                       help="one temperature per class (classes without positives keep T=1)")
    p_cal.add_argument("--bins", type=int, default=15, help="reliability bins for the ECE")
    p_cal.add_argument("-o", "--out", default=None, metavar="JSON",
                       help="write the calibration file")
    p_cal.add_argument("--batch-size", type=int, default=32)

    p_all = sub.add_parser("all", help="gsc + audioset with one model load")
    p_all.add_argument("experiment_path")
    p_all.add_argument("--eval-data", default="datasets/gsc/data/labels/test_gsc_aslabels.tsv")
    p_all.add_argument("--audioset-eval-data", default="datasets/audioset/data/labels/eval.csv")
    p_all.add_argument("--batch-size", type=int, default=32)

    for sp in (p_as, p_gsc, p_all, p_cal):
        sp.add_argument("--fast", action="store_true",
                        help="3-pass bf16 DFT + transposed layout (<=1e-3 prob drift); "
                             "omit for parity gates")
        sp.add_argument("--data-parallel", action="store_true",
                        help="shard eval batches over all visible cards of --device (fast: "
                             "the per-sample clamp; exact: the batch-global clamp)")
        sp.add_argument("--bucket-seconds", type=float, default=None,
                        help="pad batches to second-multiples (few batch shapes)")
        sp.add_argument("--dtype", default="float32", choices=["float32", "int16"],
                        help="int16 moves batches as raw PCM (bitwise-identical results)")
        sp.add_argument("--scan", type=int, default=1, metavar="K",
                        help="run K consecutive same-shape batches as one block")
    for sp in (p_as, p_gsc, p_all, p_cal, p_strong, p_ts):
        sp.add_argument("--dispatch-depth", type=int, default=4,
                        help="batch outputs kept on the card before the oldest is copied "
                             "back (results identical at any depth; 1 = synchronous)")
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    ev = Evaluator(args.experiment_path,
                   batch_size=getattr(args, "batch_size", 32),
                   fast=getattr(args, "fast", False),
                   data_parallel=getattr(args, "data_parallel", False),
                   bucket_seconds=getattr(args, "bucket_seconds", None),
                   dtype=getattr(args, "dtype", "float32"),
                   scan_batches=getattr(args, "scan", 1),
                   dispatch_depth=args.dispatch_depth, device=args.device)
    if args.command == "all":
        print(ev.gsc(eval_data=args.eval_data))
        results = ev.audioset(audioset_eval_data=args.audioset_eval_data)
        print({k: v for k, v in results.items() if not hasattr(v, "shape")})
    elif args.command == "audioset":
        results = ev.audioset(audioset_eval_data=args.audioset_eval_data,
                              label_csv=args.label_csv, dump_predictions=args.dump_predictions)
        print({k: v for k, v in results.items() if not hasattr(v, "shape")})
    elif args.command == "calibrate":
        results = ev.calibrate(eval_data=args.eval_data, num_classes=args.num_classes,
                               per_class=args.per_class, n_bins=args.bins, out=args.out)
        print(results)
        if args.out:
            print(f"  calibration -> {args.out}")
    elif args.command == "gsc":
        results = ev.gsc(eval_data=args.eval_data, threshold=args.threshold, pad=args.pad,
                         sweep=args.sweep, tie_mode=args.tie_mode,
                         dump_predictions=args.dump_predictions)
        print({k: v for k, v in results.items() if not k.startswith("_")})
    elif args.command == "strong":
        _strong(ev, args)
    else:
        ev.test_sample(args.experiment_path, args.sample, topk=args.topk)
    return 0


def _strong(ev: Evaluator, args) -> None:
    threshold = args.threshold
    if args.thresholds is not None:
        from ..evaluate.events import load_thresholds

        threshold = load_thresholds(args.thresholds)
    results = ev.strong(
        eval_data=args.eval_data, threshold=threshold, min_overlap=args.min_overlap,
        median_kernel=args.median_kernel, event_collar=args.event_collar,
        offset_collar_rate=args.offset_collar_rate, min_duration=args.min_duration,
        merge_gap=args.merge_gap, dump_events=args.dump_events, criterion=args.criterion,
        dtc=args.dtc, gtc=args.gtc, cttc=args.cttc,
        sweep=((args.sweep or (0.1, 0.2, 0.3, 0.5, 0.7, 0.9))
               if args.sweep is not None else None),
        psds=({"alpha_st": args.psds_alpha_st, "alpha_ct": args.psds_alpha_ct,
               "e_max": args.psds_e_max} if args.psds else None),
        thresholds_out=args.thresholds_out)
    print({k: v for k, v in results.items() if not k.startswith("_")})
    for th, row in sorted(results.get("_event_operating_curve", {}).items()):
        print(f"  thr={th:.2f}: " + "  ".join(f"{k}={v:.4f}" for k, v in sorted(row.items())))
    if "_best_event_threshold" in results:
        print(f"  best thresholds: event-F1 @ {results['_best_event_threshold']:.2f}, "
              f"segment-F1 @ {results['_best_segment_threshold']:.2f}")
    if args.thresholds_out:
        print(f"  per-class operating points -> {args.thresholds_out}")
        per_cls = results.get("_best_event_threshold_per_class") or {}
        if per_cls:
            print("  per-class event-F1 thresholds: " + "  ".join(
                f"{c}@{t:.2f}" for c, t in sorted(per_cls.items())))
    if args.psds:
        roc = results.get("_psd_roc", {})
        print("  PSD-ROC: " + "  ".join(f"{e:.1f}/hr->{v:.3f}" for e, v in sorted(roc.items())))


if __name__ == "__main__":
    sys.exit(main())
