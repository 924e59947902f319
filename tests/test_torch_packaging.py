"""What an installed copy of the port needs besides its Python modules.

The port reads three kinds of files from its own tree at run time: the
CUDA kernel sources that ``ops/build.py`` compiles with nvcc, the native
collate's source that ``native/build.py`` compiles with g++ (the port has
no numpy fallback for the batches it assembles natively), and the label
CSV of the CLIs. Each must be covered by a ``[tool.setuptools.package-data]``
glob of ``pyproject.toml``, or an installed copy raises on its path; and the
two build modules must name no file outside the package (their build caches
live under ``uit_mobile_tpu_torch/_build``).
"""

import fnmatch
import importlib
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "uit_mobile_tpu_torch"
RUNTIME_SOURCES = ["csrc/mel.cu", "native/uitdata.cc", "data/merged_class_label_indices.csv"]


def _globs():
    conf = tomllib.loads((REPO / "pyproject.toml").read_text())
    return conf["tool"]["setuptools"]["package-data"]["uit_mobile_tpu_torch"]


def _shipped(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, g) for g in _globs())


@pytest.mark.parametrize("rel", RUNTIME_SOURCES)
def test_runtime_sources_are_package_data(rel):
    assert (PKG / rel).is_file(), rel
    assert _shipped(rel), (rel, _globs())


def test_every_non_python_file_of_the_port_is_shipped():
    """Every file of the port's tree that is neither Python nor built is
    covered (a new kernel source or data file cannot be left out)."""
    files = [p.relative_to(PKG).as_posix() for p in PKG.rglob("*") if p.is_file()
             and p.suffix not in (".py", ".pyc")
             and not {"_build", "__pycache__"} & set(p.relative_to(PKG).parts)]
    assert set(RUNTIME_SOURCES) <= set(files)
    assert [f for f in files if not _shipped(f)] == []


@pytest.mark.parametrize("module", ["ops.build", "native.build"])
def test_build_modules_name_no_file_outside_the_package(module):
    mod = importlib.import_module(f"uit_mobile_tpu_torch.{module}")
    paths = {k: v for k, v in vars(mod).items() if isinstance(v, Path)}
    assert paths, module
    for name, path in paths.items():
        assert path.resolve().is_relative_to(PKG), (name, path)
