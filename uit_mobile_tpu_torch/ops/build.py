"""Build the port's CUDA kernels from ``uit_mobile_tpu_torch/csrc`` at first use.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers: seconds, not minutes)
and loaded with ``ctypes``. Libraries land in ``uit_mobile_tpu_torch/_build/``
(listed in ``.gitignore``) under a name keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is loaded as is.
All sources compile in parallel, one ``nvcc`` process each. Importing this
module needs no ``nvcc``; only a build does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source stem -> nvcc/ptxas output of its build


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels are built from source at first use")
    return nvcc


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}_{_digest(src)}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale ``csrc/*.cu`` in parallel; -> {stem: library path}.
    Raises RuntimeError with nvcc's output if any build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    paths = {src.stem: _lib_path(src) for src in sources}
    stale = [src for src in sources if not paths[src.stem].exists()]
    if not stale:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in stale:
        tmp = paths[src.stem].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[src.stem] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[src.stem])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building on first use)."""
    with _lock:
        if stem not in _libs:
            path = build_all()[stem]
            _libs[stem] = ctypes.CDLL(str(path))
        return _libs[stem]
