"""Local multi-process launcher: N ranks of ``cli.train`` on one machine.

    python -m uit_mobile_tpu_torch.cli.launch 2 train configs/train_uit_xs.yaml \\
        [--key value ...] [--device cuda|cpu] [--auto-resume N]

Each rank is ``python -m uit_mobile_tpu_torch.cli.train <command> <config>
--multihost {coordinator_address, num_processes, process_id} --device D``
wired to a localhost coordinator on a free port; on the card, rank r takes
card r (NCCL needs one card a rank), on the CPU gloo. Rank output streams
with a ``[rank N]`` prefix; the exit code is nonzero if any rank fails.
On a cluster every host runs the same ``cli.train`` command with
``multihost: true`` and its launcher's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/
RANK instead.

``--auto-resume N``: when any rank fails, every rank is taken down (the
others would wait in collectives that cannot finish) and all are
relaunched with ``--resume auto``, up to N times; each trainer resumes
from the run directory's per-epoch ``last.npz`` (rank 0 writes it), so
at most one epoch is lost. The run directory is pinned across attempts
(``--outputdir`` for train/run/sed; MAE's directory is fixed by its
config). A rank that never joins makes the others raise after
``parallel.multihost.DEFAULT_TIMEOUT_S``.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_devices(device: str, nproc: int) -> list[str]:
    if device != "cuda":
        return [device] * nproc
    import torch

    cards = torch.cuda.device_count()
    if cards == 0:
        raise SystemExit("--device cuda needs a CUDA GPU; pass --device cpu for gloo on the CPU")
    if nproc > cards:
        raise SystemExit(f"{nproc} ranks on {cards} card(s): NCCL takes one card a rank")
    return [f"cuda:{r}" for r in range(nproc)]


def _launch_once(args, extra: list[str]) -> list[int]:
    """Start every rank; on the first failed rank terminate the rest. ->
    the ranks' exit codes."""
    port = _free_port()
    procs = []
    for rank, device in enumerate(_rank_devices(args.device, args.nproc)):
        mh = (f"{{'coordinator_address': '127.0.0.1:{port}', "
              f"'num_processes': {args.nproc}, 'process_id': {rank}}}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "uit_mobile_tpu_torch.cli.train", args.command, args.config,
             "--multihost", mh, "--device", device, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def pump(rank: int, proc: subprocess.Popen) -> None:
        for line in proc.stdout:
            sys.stdout.write(f"[rank {rank}] {line}")
            sys.stdout.flush()

    pumps = [threading.Thread(target=pump, args=(r, p), daemon=True)
             for r, p in enumerate(procs)]
    for t in pumps:
        t.start()
    # a failed rank takes the others down at once: they would wait in
    # collectives that cannot finish
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            break
        time.sleep(0.3)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=30))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    for t in pumps:
        t.join(timeout=10)
    for rank, code in enumerate(codes):
        if code:
            print(f"[launch] rank {rank} exited {code}", file=sys.stderr)
    return codes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="uit-launch-torch",
                                     description="run N local cli.train ranks as one job")
    parser.add_argument("nproc", type=int)
    parser.add_argument("command", choices=["train", "run", "pretrain", "sed"])
    parser.add_argument("config")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: rank r on card r, NCCL) or cpu (gloo)")
    parser.add_argument("--auto-resume", type=int, default=0, metavar="N",
                        help="coordinated restarts: on any rank's failure relaunch every "
                             "rank with --resume auto, up to N times")
    args, rest = parser.parse_known_args(argv)
    if args.nproc < 1:
        parser.error("nproc must be >= 1")

    extra = list(rest)
    if args.auto_resume and args.command in ("train", "run", "sed") and "--outputdir" not in rest:
        # restarts must land in the same run directory to find last.npz
        from ..utils import parse_config_or_kwargs

        cfg = parse_config_or_kwargs(args.config)
        rundir = (Path(cfg.get("outputpath", "experiments")) / "mhlaunch"
                  / f"{Path(args.config).stem}_{os.getpid()}")
        extra += ["--outputdir", str(rundir)]
        print(f"[launch] pinned run dir {rundir}", file=sys.stderr)

    for attempt in range(args.auto_resume + 1):
        codes = _launch_once(args, extra + (["--resume", "auto"] if attempt else []))
        if not any(codes):
            return 0
        if attempt < args.auto_resume:
            print(f"[launch] attempt {attempt + 1}/{args.auto_resume + 1} failed; coordinated "
                  f"restart of all {args.nproc} ranks with --resume auto", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
