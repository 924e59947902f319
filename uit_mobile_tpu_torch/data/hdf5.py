"""HDF5-backed audio datasets, samplers, batching and the device prefetch,
counterpart of ``uit_mobile_tpu/data/hdf5.py``.

Waveforms are stored as int16 PCM keyed by filename; they come out as
float32 / 32768 or, with ``dtype='int16'``, raw (every frontend folds the
scale in bitwise). Batches are numpy dicts; ``device_prefetch`` moves them
to the training device on a background thread through pinned host memory.
h5py is imported only where a file is opened, pandas only by the manifest
reader, so in-memory datasets run without either. A manifest's
``hdf5path`` may also name a ``.npz`` store (``np.savez(path, **{filename:
PCM})``), read with numpy alone, for a machine without h5py.
"""

from __future__ import annotations

import queue
import random as _random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from ..frontend import normalize_pcm16, quantize_pcm16
from .manifest import multihot


def _convert(data: np.ndarray, dtype) -> np.ndarray:
    """Stored PCM -> the emission dtype ('int16' raw, else float32 / 32768)."""
    if dtype == np.int16:
        if data.dtype == np.int16:
            return data
        if np.issubdtype(data.dtype, np.integer):
            raise ValueError(f"dtype='int16' requires int16 PCM storage, got {data.dtype}")
        return quantize_pcm16(data)
    if np.issubdtype(data.dtype, np.integer):
        return normalize_pcm16(data)
    return np.asarray(data, dtype=np.float32)


class _Rows:
    """A list of manifest rows, read as the datasets read a DataFrame."""

    def __init__(self, rows):
        self.iloc = list(rows)

    def __len__(self) -> int:
        return len(self.iloc)


class WeakHDF5Dataset:
    """Full-clip dataset over a manifest DataFrame: index -> (waveform,
    multihot target, filename). The manifest may also be a list of row
    mappings whose ``hdf5path`` is an in-memory {filename: PCM array}
    store, which needs neither pandas nor h5py."""

    def __init__(self, data_frame, num_classes: int, dtype: str = "float32"):
        if dtype not in ("float32", "int16"):
            raise ValueError(f"dtype must be 'float32' or 'int16', got {dtype!r}")
        self._dataframe = (data_frame.reset_index(drop=True)
                           if hasattr(data_frame, "reset_index") else _Rows(data_frame))
        self._num_classes = num_classes
        self._dtype = np.int16 if dtype == "int16" else np.float32
        self._local = threading.local()  # per-thread h5 handle cache

    def __len__(self) -> int:
        return len(self._dataframe)

    def _file(self, hdf5path):
        if isinstance(hdf5path, Mapping):  # an in-memory store
            return hdf5path
        cache = getattr(self._local, "cache", None)
        if cache is None:
            cache = self._local.cache = {}
        if hdf5path not in cache:
            if str(hdf5path).endswith(".npz"):  # np.savez(path, **{filename: PCM})
                cache[hdf5path] = np.load(hdf5path)
            else:
                from h5py import File

                cache[hdf5path] = File(hdf5path, "r")
        return cache[hdf5path]

    def _node(self, hdf5path: str, fname: str):
        try:
            return self._file(hdf5path)[fname]
        except KeyError:
            where = "the in-memory store" if isinstance(hdf5path, Mapping) else hdf5path
            raise KeyError(
                f"waveform key {fname!r} not found in {where} — check the manifest's "
                f"filename column against the HDF5 keys (a basename=True/False mismatch "
                f"drops or mangles paths)") from None

    def _read(self, hdf5path: str, fname: str) -> np.ndarray:
        return _convert(self._node(hdf5path, fname)[:], self._dtype)

    def __getitem__(self, index: int):
        row = self._dataframe.iloc[index]
        target = multihot(row["labels"], self._num_classes)
        return self._read(row["hdf5path"], row["filename"]), target, row["filename"]


def _crop_or_pad(rng: _random.Random, n: int, L: int, read):
    """A random L-sample crop of an n-sample clip, or the clip zero-padded
    at a random offset; ``read(lo, hi)`` reads samples [lo, hi)."""
    if n > L:
        start = rng.randint(0, n - L - 1)
        return read(start, start + L)
    loaded = read(0, n)
    data = np.zeros(L, dtype=loaded.dtype)
    start = rng.randint(0, L - n - 1) if L > n else 0
    data[start:start + n] = loaded
    return data


class WeakRandomCropHDF5Dataset(WeakHDF5Dataset):
    """Random fixed-length crop (long clips) or random-offset zero pad
    (short clips)."""

    def __init__(self, data_frame, chunk_length: float, num_classes: int,
                 sample_rate: int = 16000, rng: Optional[_random.Random] = None,
                 dtype: str = "float32"):
        super().__init__(data_frame, num_classes, dtype=dtype)
        self.chunk_length = int(chunk_length * sample_rate)
        self._rng = rng or _random.Random()

    def _read(self, hdf5path: str, fname: str) -> np.ndarray:
        node = self._node(hdf5path, fname)
        data = _crop_or_pad(self._rng, node.shape[-1], self.chunk_length,
                            lambda lo, hi: node[lo:hi])
        return _convert(data, self._dtype)


class WeakChunkedHDF5Dataset(WeakHDF5Dataset):
    """Reads of the 'from'/'to' interval (seconds) of a strong-label
    manifest row; with ``fixed_length`` each interval is random-cropped or
    zero-padded to that many seconds."""

    def __init__(self, data_frame, num_classes: int, sample_rate: int = 16000,
                 fixed_length: Optional[float] = None,
                 rng: Optional[_random.Random] = None, dtype: str = "float32"):
        super().__init__(data_frame, num_classes, dtype=dtype)
        self._sr = sample_rate
        self._fixed = int(fixed_length * sample_rate) if fixed_length else None
        self._rng = rng or _random.Random()

    def __getitem__(self, index: int):
        row = self._dataframe.iloc[index]
        target = multihot(row["labels"], self._num_classes)
        node = self._node(row["hdf5path"], row["filename"])
        hi = min(int(float(row["to"]) * self._sr), node.shape[-1])
        lo = min(max(int(float(row["from"]) * self._sr), 0), hi)
        if lo >= hi:
            raise ValueError(f"{row['filename']}: event interval [{row['from']}, {row['to']})s "
                             f"lies outside the {node.shape[-1]}-sample clip — fix the "
                             f"manifest row")
        if self._fixed is None:
            data = node[lo:hi]
        else:
            data = _crop_or_pad(self._rng, hi - lo, self._fixed,
                                lambda a, b: node[lo + a:lo + b])
        return _convert(data, self._dtype), target, row["filename"]


def strong_window(rng: _random.Random, node, events, chunk: int, sample_rate: int,
                  n_segments: int, seg_seconds: float, num_classes: int,
                  min_overlap: float):
    """One SED training window of a clip (``node``: an array or h5py
    dataset of n samples): a random ``chunk``-sample crop (long clip) or a
    random-offset zero pad (short clip), and its (n_segments, num_classes)
    targets, the clip's (class, onset_s, offset_s) events moved into window
    time and rasterized onto segments of ``seg_seconds``
    (evaluate.metrics.segment_events_to_targets) -> (data, target)."""
    from ..evaluate.metrics import segment_events_to_targets

    n, L = node.shape[-1], chunk
    if n > L:
        ws = rng.randint(0, n - L - 1)
        data, off = node[ws:ws + L], 0
    else:
        loaded = node[:]
        data = np.zeros(L, dtype=loaded.dtype)
        off = rng.randint(0, L - n - 1) if L > n else 0
        data[off:off + n] = loaded
        ws = 0
    shift = (off - ws) / sample_rate
    moved = [(c, on + shift, end + shift) for c, on, end in events]
    times = np.asarray([[k * seg_seconds, (k + 1) * seg_seconds] for k in range(n_segments)],
                       dtype=np.float64)
    return data, segment_events_to_targets(times, moved, num_classes, min_overlap=min_overlap)


def strong_window_rng(index: int) -> _random.Random:
    """The window stream of item ``index`` in deterministic (evaluation)
    mode: a function of the index only, so threaded loaders score the same
    windows every epoch."""
    return _random.Random(0x5ED0 + index)


class StrongFramewiseHDF5Dataset(WeakHDF5Dataset):
    """SED training dataset: one item per file (the manifest rows of a
    filename are its labeled event intervals, filename/labels/hdf5path/
    from/to) -> (random window, (n_segments, num_classes) targets,
    filename), by ``strong_window``. ``deterministic=True`` draws each
    item's window from ``strong_window_rng(index)``."""

    def __init__(self, data_frame, num_classes: int, n_segments: int, seg_seconds: float,
                 chunk_length: float = 1.0, sample_rate: int = 16000,
                 min_overlap: float = 0.5, rng: Optional[_random.Random] = None,
                 dtype: str = "float32", deterministic: bool = False):
        import pandas as pd

        from .manifest import events_by_file

        groups = events_by_file(data_frame)
        df = pd.DataFrame([(f, [e[0] for e in ev], h) for f, h, ev in groups],
                          columns=["filename", "labels", "hdf5path"])
        super().__init__(df, num_classes, dtype=dtype)
        self._events = [ev for _, _, ev in groups]
        self._sr = sample_rate
        self._chunk = int(chunk_length * sample_rate)
        self._n_seg, self._seg_s, self._min_ov = n_segments, seg_seconds, min_overlap
        self._rng = rng or _random.Random()
        self._det = deterministic

    def __getitem__(self, index: int):
        row = self._dataframe.iloc[index]
        rng = strong_window_rng(index) if self._det else self._rng
        data, target = strong_window(rng, self._node(row["hdf5path"], row["filename"]),
                                     self._events[index], self._chunk, self._sr, self._n_seg,
                                     self._seg_s, self._num_classes, self._min_ov)
        return _convert(data, self._dtype), target, row["filename"]


class UnlabeledRandomChunkedHDF5Dataset(WeakRandomCropHDF5Dataset):
    """Self-supervised variant: random chunks, all-zero targets; a manifest
    without a labels column is accepted."""

    def __init__(self, data_frame, chunk_length: float = 2.0, sample_rate: int = 16000,
                 num_classes: int = 527, rng=None):
        df = data_frame.copy()
        if "labels" not in df.columns:
            df["labels"] = [[] for _ in range(len(df))]
        super().__init__(df, chunk_length, num_classes, sample_rate, rng)

    def __getitem__(self, index: int):
        row = self._dataframe.iloc[index]
        data = self._read(row["hdf5path"], row["filename"])
        return data, np.zeros(self._num_classes, np.float32), row["filename"]


# ----------------------------------------------------------------- batching

def pad_batch(waves: Sequence[np.ndarray], padding_value: float = 0.0):
    """Right-pad to the batch max -> ((B, T), lengths); int16 stays int16."""
    if not waves:
        raise ValueError("pad_batch: empty batch")
    lengths = np.asarray([w.shape[-1] for w in waves], dtype=np.int32)
    pcm16 = waves[0].dtype == np.int16
    if not all((w.dtype == np.int16) == pcm16 for w in waves):
        raise ValueError("pad_batch: mixed int16/float waveforms in one batch")
    out = np.full((len(waves), int(lengths.max())), padding_value,
                  dtype=np.int16 if pcm16 else np.float32)
    for i, w in enumerate(waves):
        out[i, : w.shape[-1]] = w
    return out, lengths


def collate(samples):
    """[(wav, target, fname)] -> {'wav', 'target', 'lengths', 'filenames'}.
    The JAX package's native collate engages only for clips of >= 100k
    samples; it is not ported, numpy pads every batch."""
    waves, targets, fnames = zip(*samples)
    data, lengths = pad_batch(waves)
    return {"wav": data, "target": np.stack(targets), "lengths": lengths,
            "filenames": list(fnames)}


# ----------------------------------------------------------------- samplers

class BalancedSampler:
    """Label-frequency-balanced sampling with replacement: weight(sample) =
    sum over its labels of 1000 / (class_count + offset). ``labels_series``
    is a pandas Series of label lists."""

    def __init__(self, labels_series, offset: int = 100, random_state: Optional[int] = None):
        single = labels_series.copy().explode().reset_index()
        single.columns = ["index", "label"]
        occurrences = single.groupby("label")["index"].apply(len).sort_index()
        weights = (1000.0 / (occurrences + offset)).to_dict()
        w = labels_series.apply(lambda lab: sum(weights[c] for c in lab)).values
        self._p = np.array(w, dtype=np.float64, copy=True)
        self._p /= self._p.sum()
        self._n = len(self._p)
        self._rng = np.random.default_rng(random_state)

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[int]:
        yield from self._rng.choice(self._n, size=self._n, p=self._p)


class RandomSampler:
    def __init__(self, n: int, seed: Optional[int] = None):
        self._n = n
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._n

    def __iter__(self):
        yield from self._rng.permutation(self._n)


class SequentialSampler:
    def __init__(self, n: int):
        self._n = n

    def __len__(self):
        return self._n

    def __iter__(self):
        yield from range(self._n)


# ------------------------------------------------------------------ loaders

class DataLoader:
    """Map-style loader: sampler -> thread-pool fetch -> collate, a few
    batches in flight. Threads carry the h5py reads (libhdf5 releases the
    GIL) and the batches land in this process's memory."""

    def __init__(self, dataset, batch_size: int, sampler=None, shuffle: bool = False,
                 num_workers: int = 2, drop_last: bool = False, seed=None,
                 collate_fn=collate):
        self.dataset = dataset
        self.batch_size = batch_size
        if sampler is None:
            sampler = RandomSampler(len(dataset), seed) if shuffle else SequentialSampler(len(dataset))
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load(self, idxs):
        return self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        idxs = list(iter(self.sampler))
        batches = [idxs[i: i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = [pool.submit(self._load, b) for b in batches[:3]]
            for b in batches[3:]:
                fut = pending.pop(0)
                pending.append(pool.submit(self._load, b))
                yield fut.result()
            for fut in pending:
                yield fut.result()


class MultiDataLoader:
    """Zip named child loaders into dict batches, re-iterating each child on
    exhaustion: an infinite stream, bounded by the trainer's epoch_length."""

    def __init__(self, **loaders):
        self.loaders = loaders
        self._iters = {k: iter(v) for k, v in loaders.items()}

    def __len__(self) -> int:
        return min(len(dl) for dl in self.loaders.values())

    def __iter__(self):
        while True:
            out = {}
            for key in self._iters:
                try:
                    out[key] = next(self._iters[key])
                except StopIteration:
                    self._iters[key] = iter(self.loaders[key])
                    try:
                        out[key] = next(self._iters[key])
                    except StopIteration:
                        raise ValueError(
                            f"MultiDataLoader child '{key}' yields zero batches (dataset "
                            f"smaller than batch_size with drop_last, or an empty "
                            f"manifest)") from None
            yield out


def to_device(batch, device: torch.device):
    """numpy arrays of a (nested) batch -> tensors on ``device``: through
    pinned host memory and a ``non_blocking`` copy on a CUDA device (the
    copy is ordered on the current stream, before the work that reads it).
    Filenames and other non-array leaves pass through."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray) and batch.dtype != object:
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return batch


def device_prefetch(iterator, device, size: int = 2):
    """Move batches to ``device`` ahead of consumption on a background
    thread (``to_device``). The producer stops when the consumer closes or
    drops the generator; a producer error is raised in the consumer."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put(to_device(batch, device)):
                    return
        except BaseException as e:  # surface I/O errors to the consumer
            put((_END, e))
            return
        put((_END, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
                if item[1] is not None:
                    raise RuntimeError("device_prefetch producer failed") from item[1]
                break
            yield item
    finally:
        stop.set()  # release the producer even mid-put
        while True:  # drain so a producer blocked on a full queue exits
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
