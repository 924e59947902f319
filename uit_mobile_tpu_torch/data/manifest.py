"""Manifest (TSV/CSV) reading, counterpart of ``uit_mobile_tpu/data/manifest.py``.

Whitespace-separated columns ``filename``, ``labels`` (";"-joined int class
indices) and ``hdf5path``. With basename=True, filenames are reduced to
their basename unless they contain 'Google_Speech_Commands'. pandas is
imported only where a manifest is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_tsv_data(datafile, nrows: int | None = None, basename: bool = True):
    """-> pandas DataFrame with ``labels`` as lists/arrays of int."""
    import pandas as pd

    df = pd.read_csv(datafile, sep=r"\s+", nrows=nrows).astype(str)
    missing = {"hdf5path", "filename", "labels"} - set(df.columns)
    if missing:
        raise ValueError(
            f"manifest {datafile} must have filename/labels/hdf5path columns "
            f"(missing: {sorted(missing)}; found: {list(df.columns)})")
    na_rows = df[["filename", "labels", "hdf5path"]].isna().any(axis=1)
    if na_rows.any():
        raise ValueError(f"manifest {datafile} has rows with missing filename/labels/hdf5path "
                         f"values (row indices: {list(df.index[na_rows][:10])})")
    try:
        if df["labels"].str.contains(";").any():
            df["labels"] = df["labels"].str.split(";").apply(lambda x: np.array(x, dtype=int))
        else:
            df["labels"] = df["labels"].apply(lambda x: [int(x)])
    except ValueError as e:
        raise ValueError(f"manifest {datafile} has a malformed labels column (expected "
                         f"';'-joined integer class indices): {e}") from e
    if basename:
        df["filename"] = df["filename"].apply(
            lambda x: x if "Google_Speech_Commands" in x else Path(x).name)
    return df


def events_by_file(df):
    """Group a strong-label manifest (one labeled event interval per row:
    filename/labels/hdf5path/from/to) by file ->
    [(filename, hdf5path, [(class_idx, onset_s, offset_s), ...]), ...] in
    first-appearance order; negative label indices are dropped."""
    groups = []
    for (h5, fname), g in df.groupby(["hdf5path", "filename"], sort=False):
        events = [(int(lab), float(row["from"]), float(row["to"]))
                  for _, row in g.iterrows() for lab in row["labels"] if int(lab) >= 0]
        groups.append((fname, h5, events))
    return groups


def multihot(label_idxs, num_classes: int) -> np.ndarray:
    target = np.zeros(num_classes, dtype=np.float32)
    idxs = np.asarray(label_idxs, dtype=np.int64)
    idxs = idxs[idxs >= 0]
    if idxs.size:
        hi = int(idxs.max())
        if hi >= num_classes:
            raise ValueError(f"label index {hi} out of range for num_classes={num_classes} — "
                             f"the manifest's labels don't match the configured head width")
        target[idxs] = 1.0
    return target
