"""The readings that a cell's limits are set from, at the cell's own size,
on each seed given:

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3
    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 --program 3

The first prints one JSON line a seed with the control's numbers: the
plain reference put in the program's place at the next precision down
(TF32 for the configurations' float32 with TF32 off), and the faults and
witnesses that the cell's driver reads (its ``control``). The second runs
the cell itself, set-up, a window of that many seconds and the
comparison, for each seed in one process, and prints the numbers its
check compares. The benchmark's runs never run either; a cell's limits
are set between the program's readings and the control's.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    import argparse

    import torch

    from bench_port import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=float, default=None, metavar="SECONDS",
                    help="the program's readings over a window of SECONDS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control: no CUDA card")
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        if args.program is None:
            out = {"control": harness.driver(cell).control(harness.Context(cell, seed, dev))}
        else:
            _, checks = harness.run_cell(cell, seed, args.program, False, dev, t)
            out = {"program": {c.name: c.value for c in checks}}
        print(json.dumps({"workload": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
