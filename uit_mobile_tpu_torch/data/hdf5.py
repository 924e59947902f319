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
        # the columns an item reads, as lists: a row lookup of a DataFrame
        # costs tens of us, which the iterating thread would pay every draw
        self._fnames = _column(self._dataframe, "filename")
        self._paths = _column(self._dataframe, "hdf5path")
        self._labels = _column(self._dataframe, "labels")
        self._lengths = np.full(len(self._dataframe), -1, dtype=np.int64)  # -1: not read yet

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
            raise _missing(hdf5path, fname) from None

    def _clip_length(self, index: int) -> int:
        """Item ``index``'s clip length in samples, read (``_length``) the
        first time it is asked for and kept: a clip's length does not
        change between passes."""
        n = int(self._lengths[index])
        if n < 0:
            n = self._lengths[index] = self._length(self._paths[index], self._fnames[index])
        return n

    def _length(self, hdf5path, fname: str) -> int:
        """The clip's sample count, from its header alone: an ``.npz``
        member's array header, an HDF5 dataset's shape, an array's."""
        f = self._file(hdf5path)
        if not hasattr(f, "zip"):  # an HDF5 file or an in-memory store
            return self._node(hdf5path, fname).shape[-1]
        try:  # an .npz store: indexing it would read the samples
            fp = f.zip.open(fname + ".npy")
        except KeyError:
            raise _missing(hdf5path, fname) from None
        with fp:
            version = np.lib.format.read_magic(fp)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            return read(fp)[0][-1]

    def draw(self, index: int):
        """Item ``index``'s random draws, made before it is read.
        ``DataLoader`` calls this on its iterating thread in sampler order,
        so the draws never depend on which pool thread reads first. None:
        this dataset draws nothing."""
        return None

    def fetch(self, index: int, drawn=None):
        """Item ``index`` at its draws (``draw``) -> (waveform, multihot
        target, filename); reads and converts only."""
        fname = self._fnames[index]
        target = multihot(self._labels[index], self._num_classes)
        return self._read(self._paths[index], fname, drawn), target, fname

    def __getitem__(self, index: int):
        return self.fetch(index, self.draw(index))

    def _read(self, hdf5path: str, fname: str, drawn=None) -> np.ndarray:
        return _convert(self._node(hdf5path, fname)[:], self._dtype)


def _column(frame, name: str) -> Optional[list]:
    """A manifest column as a list; None where the manifest lacks it."""
    if isinstance(frame, _Rows):
        return [r[name] for r in frame.iloc] if all(name in r for r in frame.iloc) else None
    return frame[name].tolist() if name in frame.columns else None


def _missing(hdf5path, fname: str) -> KeyError:
    where = "the in-memory store" if isinstance(hdf5path, Mapping) else hdf5path
    return KeyError(f"waveform key {fname!r} not found in {where} — check the manifest's "
                    f"filename column against the HDF5 keys (a basename=True/False mismatch "
                    f"drops or mangles paths)")


def draw_start(rng: _random.Random, n: int, L: int) -> int:
    """The one draw of a random L-sample window of an n-sample clip: the
    crop's start (n > L), else the zero pad's offset (0 when n == L)."""
    if n > L:
        return rng.randint(0, n - L - 1)
    return rng.randint(0, L - n - 1) if L > n else 0


def place(start: int, n: int, L: int, read) -> np.ndarray:
    """The window ``draw_start`` drew as ``start``: samples [start, start +
    L) of a longer clip, else the clip zero-padded at offset ``start``;
    ``read(lo, hi)`` reads samples [lo, hi)."""
    if n > L:
        return read(start, start + L)
    loaded = read(0, n)
    data = np.zeros(L, dtype=loaded.dtype)
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

    def draw(self, index: int) -> int:
        return draw_start(self._rng, self._clip_length(index), self.chunk_length)

    def _read(self, hdf5path: str, fname: str, drawn=None) -> np.ndarray:
        node = self._node(hdf5path, fname)
        return _convert(place(drawn, node.shape[-1], self.chunk_length,
                              lambda lo, hi: node[lo:hi]), self._dtype)


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
        self._from = _column(self._dataframe, "from")
        self._to = _column(self._dataframe, "to")

    def _interval(self, index: int, n: int) -> tuple[int, int]:
        """[lo, hi) samples of item ``index``'s interval within its n-sample clip."""
        start, end = self._from[index], self._to[index]
        hi = min(int(float(end) * self._sr), n)
        lo = min(max(int(float(start) * self._sr), 0), hi)
        if lo >= hi:
            raise ValueError(f"{self._fnames[index]}: event interval [{start}, {end})s "
                             f"lies outside the {n}-sample clip — fix the manifest row")
        return lo, hi

    def draw(self, index: int):
        if self._fixed is None:
            return None
        lo, hi = self._interval(index, self._clip_length(index))
        return draw_start(self._rng, hi - lo, self._fixed)

    def fetch(self, index: int, drawn=None):
        fname = self._fnames[index]
        target = multihot(self._labels[index], self._num_classes)
        node = self._node(self._paths[index], fname)
        lo, hi = self._interval(index, node.shape[-1])
        if self._fixed is None:
            data = node[lo:hi]
        else:
            data = place(drawn, hi - lo, self._fixed, lambda a, b: node[lo + a:lo + b])
        return _convert(data, self._dtype), target, fname


def strong_window(start: int, node, events, chunk: int, sample_rate: int,
                  n_segments: int, seg_seconds: float, num_classes: int,
                  min_overlap: float):
    """One SED training window of a clip (``node``: an array or h5py
    dataset of n samples) at the window ``draw_start`` drew as ``start``:
    a ``chunk``-sample crop (long clip) or a zero pad (short clip), and its
    (n_segments, num_classes) targets, the clip's (class, onset_s,
    offset_s) events moved into window time and rasterized onto segments
    of ``seg_seconds`` (evaluate.metrics.segment_events_to_targets) ->
    (data, target)."""
    from ..evaluate.metrics import segment_events_to_targets

    n = node.shape[-1]
    data = place(start, n, chunk, lambda lo, hi: node[lo:hi])
    ws, off = (start, 0) if n > chunk else (0, start)
    shift = (off - ws) / sample_rate
    moved = [(c, on + shift, end + shift) for c, on, end in events]
    times = np.asarray([[k * seg_seconds, (k + 1) * seg_seconds] for k in range(n_segments)],
                       dtype=np.float64)
    return data, segment_events_to_targets(times, moved, num_classes, min_overlap=min_overlap)


def strong_window_rng(index: int) -> _random.Random:
    """The window stream of item ``index`` in deterministic (evaluation)
    mode: a function of the index only, so threaded loaders score the same
    windows every epoch."""
    return _random.Random(0x5ED0 + int(index))


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

    def draw(self, index: int):
        if self._det:  # the item's own stream, drawn where it is read
            return None
        return draw_start(self._rng, self._clip_length(index), self._chunk)

    def fetch(self, index: int, drawn=None):
        fname = self._fnames[index]
        node = self._node(self._paths[index], fname)
        if self._det:
            drawn = draw_start(strong_window_rng(index), node.shape[-1], self._chunk)
        data, target = strong_window(drawn, node, self._events[index], self._chunk, self._sr,
                                     self._n_seg, self._seg_s, self._num_classes, self._min_ov)
        return _convert(data, self._dtype), target, fname


class UnlabeledRandomChunkedHDF5Dataset(WeakRandomCropHDF5Dataset):
    """Self-supervised variant: random chunks, all-zero targets; a manifest
    without a labels column is accepted."""

    def __init__(self, data_frame, chunk_length: float = 2.0, sample_rate: int = 16000,
                 num_classes: int = 527, rng=None):
        df = data_frame.copy()
        if "labels" not in df.columns:
            df["labels"] = [[] for _ in range(len(df))]
        super().__init__(df, chunk_length, num_classes, sample_rate, rng)

    def fetch(self, index: int, drawn=None):
        fname = self._fnames[index]
        data = self._read(self._paths[index], fname, drawn)
        return data, np.zeros(self._num_classes, np.float32), fname


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


# the JAX package's rule for its native collate (uit_mobile_tpu/data/hdf5.py):
# long clips at small and mid batches, where the native threads win
NATIVE_MAX_BATCH = 256
NATIVE_MIN_MEAN_SAMPLES = 100_000


def uses_native(waves) -> bool:
    """Whether ``collate`` assembles these clips natively: at most
    ``NATIVE_MAX_BATCH`` clips of ``NATIVE_MIN_MEAN_SAMPLES`` samples or
    more on average (the AudioSet evaluation batch)."""
    mean_len = sum(w.shape[-1] for w in waves) / max(len(waves), 1)
    return len(waves) <= NATIVE_MAX_BATCH and mean_len >= NATIVE_MIN_MEAN_SAMPLES


def collate(samples):
    """[(wav, target, fname)] -> {'wav', 'target', 'lengths', 'filenames'}.
    Where ``uses_native``, the native data plane (``native.pad_batch_native``)
    pads the batch, and a failed build raises; elsewhere numpy does."""
    waves, targets, fnames = zip(*samples)
    if uses_native(waves):
        from ..native import pad_batch_native

        data, lengths = pad_batch_native(waves)
    else:
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
    GIL) and the batches land in this process's memory. The items' random
    draws are made on the iterating thread in sampler order, before their
    fetch goes to the pool, so a batch's bits are the same at any
    ``num_workers``."""

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

    def _draws(self, idxs):
        """The items' draws (``WeakHDF5Dataset.draw``), made on this thread
        in sampler order: what a one-worker pool draws, at any
        ``num_workers``. None for a dataset without ``draw``, whose items
        the pool reads by index."""
        draw = getattr(self.dataset, "draw", None)
        return None if draw is None else [draw(i) for i in idxs]

    def _load(self, idxs, draws):
        if draws is None:
            return self.collate_fn([self.dataset[i] for i in idxs])
        return self.collate_fn([self.dataset.fetch(i, d) for i, d in zip(idxs, draws)])

    def __iter__(self):
        return self.iterate()

    def iterate(self, skip: int = 0):
        """One pass of the sampler. ``skip``: start ``skip`` batches in,
        their draws made and nothing of them read, as a resumed run goes
        on from where it stopped."""
        idxs = list(iter(self.sampler))
        batches = [idxs[i: i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        for b in batches[:skip]:
            self._draws(b)
        batches = batches[skip:]
        if not batches:
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(b):
                return pool.submit(self._load, b, self._draws(b))

            pending = [submit(b) for b in batches[:3]]
            for b in batches[3:]:
                fut = pending.pop(0)
                pending.append(submit(b))
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

    def skip(self, n: int) -> None:
        """Start the stream ``n`` batches in, as a run that had taken them
        goes on: each child's sampler passes and draws advance
        (``DataLoader.iterate``), and nothing is read. A skipped item costs
        its draw; its clip's length is read once (``_clip_length``)."""
        for key, loader in self.loaders.items():
            per_pass = len(loader)
            if per_pass == 0:
                raise _empty_child(key)
            full, rest = divmod(n, per_pass)
            for _ in range(full):
                for _ in loader.iterate(skip=per_pass):
                    pass
            self._iters[key] = loader.iterate(skip=rest)

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
                        raise _empty_child(key) from None
            yield out


def _empty_child(key: str) -> ValueError:
    return ValueError(f"MultiDataLoader child '{key}' yields zero batches (dataset smaller "
                      f"than batch_size with drop_last, or an empty manifest)")


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
