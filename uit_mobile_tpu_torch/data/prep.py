"""Offline dataset preparation (AudioSet + Google Speech Commands V1),
counterpart of ``uit_mobile_tpu/data/prep.py``.

Turns local wav trees into stores of int16 PCM plus TSV manifests, the
artifacts the datasets read:

- a store keyed by basename (AudioSet) or full path (GSC): an HDF5 file
  (the default, the format the JAX package reads; h5py is imported only
  there) or, for an output ending in ``.npz``, the ``np.savez`` store that
  ``data/hdf5.py`` reads with numpy alone;
- TSV manifests with ``filename  labels(";"-ints)  hdf5path`` columns,
  written with the stdlib ``csv`` module in pandas' ``to_csv(sep="\\t",
  index=False)`` format, so no step needs pandas;
- the GSC label mapping: the 10 target keywords -> indices 527-536 after
  the 527 AudioSet classes, the other 20 words -> 0 (= Speech); train-split
  keywords get the dual label "0;<idx>".

Wavs are decoded by ``data/audio_io.py:read_wav``; durations come from the
wav header.
"""

from __future__ import annotations

import contextlib
import csv
import wave
import zipfile
from pathlib import Path

import numpy as np

from .audio_io import read_wav

# keyword -> merged-index map (GSC V1's 30 words; 10 keywords, 20 fillers)
LABEL_MAPS_GSC_AUDIOSET = {
    "bed": 0, "bird": 0, "cat": 0, "dog": 0, "down": 527, "eight": 0,
    "five": 0, "four": 0, "go": 528, "happy": 0, "house": 0, "left": 529,
    "marvin": 0, "nine": 0, "no": 530, "off": 531, "on": 532, "one": 0,
    "right": 533, "seven": 0, "sheila": 0, "six": 0, "stop": 534,
    "three": 0, "tree": 0, "two": 0, "up": 535, "wow": 0, "yes": 536, "zero": 0,
}


def wav_duration_seconds(path) -> float:
    with wave.open(str(path), "rb") as f:
        return round(f.getnframes() / f.getframerate(), 1)


def write_tsv(rows: list, path, columns: list) -> None:
    """Manifest rows (mappings) -> a tab-separated file with a header."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, delimiter="\t", lineterminator="\n")
        out.writerow(columns)
        out.writerows([row[c] for c in columns] for row in rows)


@contextlib.contextmanager
def store_writer(output):
    """-> put(key, pcm) writing into ``output``, an ``np.savez`` store when
    it ends in ``.npz`` (each array written as it comes, as np.savez
    writes them), else HDF5."""
    if str(output).endswith(".npz"):
        with zipfile.ZipFile(output, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
            def put(key, pcm):
                with z.open(f"{key}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, pcm)

            yield put
        return
    import h5py

    with h5py.File(output, "w") as f:
        def put(key, pcm):
            f[key] = pcm

        yield put


def dump_waves(files, output, use_fullname: bool = False, progress: bool = True) -> None:
    """Dump each listed wav into one store as int16 PCM. ``files`` is a list
    of filenames or a manifest with a ``filename`` column; the store is
    ``.npz`` when ``output`` ends so, else HDF5. A second file with the same
    key is skipped with a warning."""
    names = list(files["filename"]) if hasattr(files, "columns") else list(files)
    it = list(dict.fromkeys(names))
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(it, unit="file")
        except ImportError:
            pass
    written = set()
    with store_writer(output) as put:
        for fname in it:
            key = str(fname) if use_fullname else Path(fname).name
            if key in written:
                print(f"Warning, {fname} already exists!")
                continue
            wav, _ = read_wav(fname)
            put(key, np.clip(wav[0] * 32768.0, -32768, 32767).astype(np.int16))
            written.add(key)


def _class_index(class_labels_indices) -> dict:
    with open(class_labels_indices, newline="") as f:
        return {row["mid"]: int(row["index"]) for row in csv.DictReader(f)}


def build_audioset_manifest(root_data_dir, segments_csv, class_labels_indices,
                            min_duration: float = 0.1) -> list:
    """Scan downloaded AudioSet wavs -> manifest rows {filename, labels,
    duration} (the JAX package returns them as a DataFrame; write them with
    ``write_tsv``).

    Files are named ``{ytid}_{start}_{end}.wav``; mids map to int indices
    via the class_labels_indices CSV; empty/corrupt/short files filtered.
    """
    mid_to_index = _class_index(class_labels_indices)
    root = Path(root_data_dir).absolute()
    rows = []
    with open(segments_csv) as f:
        lines = f.read().splitlines()[3:]
    for line in lines:
        fields = [x[:-1] if x.endswith(",") else x for x in line.split()]
        if not fields:
            continue
        file_id, start, end, labels = fields[:4]
        fname = root / f"{file_id}_{start}_{end}.wav"
        if not (fname.exists() and fname.stat().st_size > 0):
            continue
        try:
            duration = wav_duration_seconds(fname)
        except (EOFError, wave.Error):
            continue
        if duration <= min_duration:
            continue
        labels = ";".join(str(mid_to_index[m]) for m in labels.strip('"').split(","))
        rows.append({"filename": str(fname), "labels": labels, "duration": duration})
    return rows


def _list(path) -> set:
    with open(path) as f:
        return {line.split(" ")[0] for line in f.read().splitlines() if line.strip()}


def prepare_gsc(gsc_root_path, output_root_dir, dump: bool = True,
                store: str = "h5") -> dict:
    """GSC V1 -> {train,valid,test} stores + TSV manifests -> {split: TSV}.

    Splits follow the official validation_list.txt/testing_list.txt;
    everything else is train. Train keywords carry the dual label
    "0;<idx>" (the clip is both Speech and the keyword). ``store`` is "h5"
    (HDF5, as the JAX package writes) or "npz"; either lives in ``hdf5/``.
    """
    if store not in ("h5", "npz"):
        raise ValueError(f"store must be 'h5' or 'npz', got {store!r}")
    gsc_root_path = Path(gsc_root_path)
    output_root_dir = Path(output_root_dir)
    valid_fns = _list(gsc_root_path / "validation_list.txt")
    test_fns = _list(gsc_root_path / "testing_list.txt")
    held_out = test_fns | valid_fns

    splits: dict = {"train": [], "valid": [], "test": []}
    for f in sorted(gsc_root_path.glob("**/*wav")):
        label = LABEL_MAPS_GSC_AUDIOSET.get(f.parent.name)
        if label is None:  # e.g. _background_noise_
            continue
        fn = f"{f.parent.name}/{f.name}"
        row = {"filename": str(f.absolute())}
        if fn in test_fns:
            splits["test"].append(dict(row, labels=label))
        if fn in valid_fns:
            splits["valid"].append(dict(row, labels=label))
        if fn not in held_out:
            splits["train"].append(dict(row, labels=f"0;{label}" if label else "0"))

    labels_dir = output_root_dir / "labels"
    hdf5_dir = output_root_dir / "hdf5"
    labels_dir.mkdir(parents=True, exist_ok=True)
    hdf5_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, part in splits.items():
        path = hdf5_dir / f"{name}.{store}"
        for row in part:
            row["hdf5path"] = str(path.absolute())
        if dump:
            print(f"Dumping wav to {store} for {name} [len {len(part)}] to {path}")
            dump_waves([row["filename"] for row in part], path, use_fullname=True)
        tsv = labels_dir / f"{name}_gsc_aslabels.tsv"
        write_tsv(part, tsv, ["filename", "labels", "hdf5path"])
        out[name] = tsv
    return out
