"""Run one cell of ``BENCHMARK.json`` once on the CUDA card:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``harness.result_line``);
the numbers compared with the plain reference, each beside its limit, are
the last lines of standard error. Without a card it exits 2 and prints no
result.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
_ROOT = Path(__file__).resolve().parent.parent
# every cache the program or torch writes stays in the checkout, at one path
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(_ROOT / "bench_port" / "_cache" / sub)
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
# one thread a library pool: no pool spins against the program's threads
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(_ROOT))

if __name__ == "__main__":
    from bench_port.harness import main

    sys.exit(main(t_start=T_START))
