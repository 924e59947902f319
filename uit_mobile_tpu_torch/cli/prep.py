"""Dataset preparation CLI: the jobs of the JAX package's ``datasets/``
scripts (gsc/2_prepare_data.py, utils/prepare_label_list.py,
utils/dump_audio_to_hdf5.py) on ``data/prep.py``, without jax or pandas.

    python -m uit_mobile_tpu_torch.cli.prep gsc RAW_DIR OUT_DIR [--store npz]
    python -m uit_mobile_tpu_torch.cli.prep audioset-manifest ROOT_DIR SEGMENTS_CSV \\
        CLASS_LABELS_INDICES OUT.tsv
    python -m uit_mobile_tpu_torch.cli.prep dump INPUT_CSV -o OUT.{h5,npz} [-u]

``gsc`` writes OUT_DIR/hdf5/{train,valid,test}.{h5,npz} and
OUT_DIR/labels/*_gsc_aslabels.tsv; ``dump`` writes an HDF5 file, or the
``.npz`` store the port's datasets read without h5py.
"""

from __future__ import annotations

import argparse
import sys


def _filenames(input_csv) -> list:
    """The ``filename`` column of a whitespace-separated manifest."""
    with open(input_csv) as f:
        rows = [line.split() for line in f.read().splitlines() if line.strip()]
    if not rows or "filename" not in rows[0]:
        raise SystemExit(f"{input_csv}: the header needs a 'filename' column")
    col = rows[0].index("filename")
    return [r[col] for r in rows[1:]]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="uit-prep-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p_gsc = sub.add_parser("gsc", help="GSC V1 -> split stores + TSV manifests")
    p_gsc.add_argument("gsc_root_path")
    p_gsc.add_argument("output_root_dir")
    p_gsc.add_argument("--store", default="h5", choices=["h5", "npz"])
    p_as = sub.add_parser("audioset-manifest", help="scan AudioSet wavs -> a manifest")
    p_as.add_argument("root_data_dir", help="root of the downloaded wavs")
    p_as.add_argument("segments_csv", help="AudioSet segments CSV")
    p_as.add_argument("class_labels_indices", help="mid -> index CSV")
    p_as.add_argument("output_csv", help="the parsed manifest")
    p_dump = sub.add_parser("dump", help="the wavs of a manifest -> one PCM store")
    p_dump.add_argument("input_csv")
    p_dump.add_argument("-o", "--output", required=True, help="OUT.h5 or OUT.npz")
    p_dump.add_argument("--use_fullname", "-u", action="store_true",
                        help="key by full path instead of basename (GSC)")
    args = parser.parse_args(argv)

    from ..data import prep

    if args.command == "gsc":
        out = prep.prepare_gsc(args.gsc_root_path, args.output_root_dir, store=args.store)
        for name, tsv in out.items():
            print(f"{name}: {tsv}")
    elif args.command == "audioset-manifest":
        rows = prep.build_audioset_manifest(args.root_data_dir, args.segments_csv,
                                            args.class_labels_indices)
        prep.write_tsv(rows, args.output_csv, ["filename", "labels", "duration"])
        print(f"wrote {len(rows)} rows to {args.output_csv}")
    else:
        prep.dump_waves(_filenames(args.input_csv), args.output,
                        use_fullname=args.use_fullname)
    return 0


if __name__ == "__main__":
    sys.exit(main())
