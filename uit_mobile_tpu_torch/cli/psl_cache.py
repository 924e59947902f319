"""Offline PSL cache builder CLI, counterpart of ``uit_mobile_tpu/cli/psl_cache.py``.

    python -m uit_mobile_tpu_torch.cli.psl_cache MANIFEST.tsv -t TEACHER -o psl_cache.h5 \\
        [--grid 1600] [--chunk-length 1.0] [--batch-size 256] [--classes 527] \\
        [--precision exact|fast] [--shard I/N] [--device cpu]

Scores every grid-aligned crop of every manifest clip with the frozen
teacher once (data/psl_cache.py:build_psl_cache), so training runs
without the teacher: ``psl: {mode: offline, cache: psl_cache.h5}``. The
teacher's mel is the fused kernel on the card (``ops.mel.make_frontend_fn``;
the CPU takes its plain version). Host i of N builds ``--shard i/N -o
cache.iofN.h5`` over the same manifest (rows i::N); training takes the set
as a glob or a list. The file is the JAX package's format: either
package's cache trains the other.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def make_teacher_fn(cfg, model, precision: str = "exact"):
    """-> fn((B, L) numpy wav batch) -> (B, C) numpy probabilities: the
    teacher's eval forward on its device through the fused mel kernel
    (``fn.frontend``, the canonical 'bft' layout), built by
    ``ops.pipeline.make_forward_fn``: a CUDA graph per batch shape on the
    card (``score_crops`` pads the last batch to the full one), as the JAX
    package jits its teacher. ``fn.eager`` scores through the same forward, never graphed;
    ``fn.forward`` is that forward (device tensors in and out), ``fn.graphs``
    its ``GraphedFn`` (None on the CPU)."""
    from ..ops.mel import make_frontend_fn
    from ..ops.pipeline import make_forward_fn

    frontend = make_frontend_fn(cfg.frontend, precision=precision)
    fwd = make_forward_fn(cfg, model, frontend_fn=frontend)

    def scorer(forward):
        def teacher(batch: np.ndarray) -> np.ndarray:
            return forward(np.ascontiguousarray(batch)).float().cpu().numpy()

        return teacher

    teacher = scorer(fwd)
    teacher.eager, teacher.forward = scorer(fwd.eager), fwd
    teacher.frontend, teacher.graphs = frontend, fwd.graphs
    return teacher


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="uit-psl-cache-torch")
    parser.add_argument("manifest", help="training manifest TSV (filename/labels/hdf5path — "
                                         "the audioset half)")
    parser.add_argument("-t", "--teacher", required=True,
                        help="teacher checkpoint spec (cli.common.resolve_model)")
    parser.add_argument("-o", "--output", required=True, help="output cache .h5")
    parser.add_argument("--grid", type=int, default=None,
                        help="crop-start grid in samples (default 1600 = 0.1 s = 10 mel hops)")
    parser.add_argument("--chunk-length", type=float, default=1.0,
                        help="crop length in seconds (config chunk_length)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--classes", type=int, default=None,
                        help="keep only the first N teacher classes (default: all)")
    parser.add_argument("--basename", action="store_true", default=True,
                        help="basename manifest filenames (default on)")
    parser.add_argument("--no-basename", dest="basename", action="store_false")
    parser.add_argument("--precision", choices=("exact", "fast"), default="exact",
                        help="frontend kernel precision for the teacher")
    parser.add_argument("--shard", default=None, metavar="I/N",
                        help="build only manifest rows i::N (one host of N, each with its "
                             "own -o; train with cache: <glob-or-list> of all N)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    shard = None
    if args.shard is not None:
        try:
            i, n = (int(p) for p in args.shard.split("/"))
        except ValueError:
            parser.error(f"--shard expects I/N (e.g. 0/4), got {args.shard!r}")
        if not 0 <= i < n:
            parser.error(f"--shard needs 0 <= I < N, got {args.shard}")
        shard = (i, n)

    from ..data import read_tsv_data
    from ..data.psl_cache import DEFAULT_GRID, build_psl_cache
    from .common import resolve_model

    df = read_tsv_data(args.manifest, basename=args.basename)
    cfg, model = resolve_model(args.teacher, device=args.device)
    t0 = time.time()
    last = [0.0]

    def progress(i, n):
        if time.time() - last[0] > 10 or i == n:
            last[0] = time.time()
            print(f"  {i}/{n} clips", flush=True)

    summary = build_psl_cache(
        df, make_teacher_fn(cfg, model, args.precision), args.output,
        chunk_length=args.chunk_length,
        grid=args.grid if args.grid is not None else DEFAULT_GRID,
        batch_size=args.batch_size, classes=args.classes, teacher_name=str(args.teacher),
        progress=progress, shard=shard)
    print(f"{args.output}: {summary['clips']} clips, {summary['crops']} crops x "
          f"{summary['classes']} classes, {summary['bytes'] / 1e6:.1f} MB in "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
