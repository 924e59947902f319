"""Build libuitdata, the native host data plane, from ``uitdata.cc``.

    python -m uit_mobile_tpu_torch.native.build [--force]

``g++`` compiles the source into ``uit_mobile_tpu_torch/_build/native/``
(listed in ``.gitignore``) under a name keyed on a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is loaded as
is. Each process compiles to a temporary name of its own and then renames
it into place, so that concurrent first uses never load a half-written
library. A failed build raises, naming the command.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "uitdata.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
# no -march=native: the build directory may travel with a copy of the tree
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libuitdata_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """-> the library's path, compiled first where it is missing (or
    ``force``). RuntimeError with the command and g++'s output on failure."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.tmp-{os.getpid()}")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building the native data plane failed: `{' '.join(cmd)}`: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the native data plane failed: `{' '.join(cmd)}` "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
