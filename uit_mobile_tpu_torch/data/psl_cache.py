"""Offline PSL: teacher targets precomputed on a crop-offset grid,
counterpart of ``uit_mobile_tpu/data/psl_cache.py`` (the same HDF5 file
format: a cache built by either package trains the other).

The frozen teacher's probabilities for a (clip, crop offset) are a pure
function of the data, so they are computed once, at data-prep time, and
the train step runs without the teacher. Crop starts are snapped to a
``grid`` (samples; default 1600 = 0.1 s = 10 mel hops). For each clip
``cache_starts`` lists the grid starts (long clips) or zero-pad offsets
(short clips) of the random crop rule; every one is scored and stored as
``(n_starts, classes)`` float16 probabilities under the clip's name, with
the file attributes ``version`` (CACHE_VERSION), ``grid``,
``chunk_length`` (samples), ``sample_rate``, ``classes``, ``teacher`` and,
for a ``--shard i/N`` build, ``shard_index``/``shard_count``.

The scoring (``score_crops``) needs no h5py: ``build_psl_cache`` writes
its output to a file, ``score_psl_cache`` keeps it in memory as a
``PSLCache``. ``PSLCacheReader`` validates one file, a shard set (files,
a glob, or in-memory caches) and draws a grid crop with its cached row;
``PSLCachedRandomCropHDF5Dataset`` is the training dataset over it, which
overwrites the first ``classes`` target columns with that row.

Every failure is loud: a clip missing from the cache, a grid or chunk
mismatch, a clip whose length changed since the build, a file that is not
a cache, or a shard set that is not one complete build raises with the
clip or file name and the fix (rebuild the cache, or train with
``psl: {mode: psl}``, the in-step teacher).
"""

from __future__ import annotations

import collections
import glob as _glob
import os
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from .hdf5 import WeakRandomCropHDF5Dataset, _convert
from .manifest import multihot

CACHE_VERSION = 1
DEFAULT_GRID = 1600  # samples: 0.1 s at 16 kHz = 10 mel hops
_REBUILD = "rebuild the cache (uit_mobile_tpu_torch.cli.psl_cache) or train with psl: {mode: psl}"


class PSLCache:
    """An in-memory PSL cache: the file's attributes and {clip name:
    (n_starts, classes) float16 probabilities}."""

    def __init__(self, attrs: dict, entries: dict):
        self.attrs = dict(attrs)
        self.entries = dict(entries)

    def keys(self):
        return self.entries.keys()

    def __getitem__(self, fname):
        return self.entries[fname]

    def __repr__(self):
        return (f"PSLCache(teacher={self.attrs.get('teacher')!r}, "
                f"clips={len(self.entries)})")


def resolve_cache_paths(cache) -> list:
    """The ``psl: {cache: ...}`` value -> a list of sources: one path, a
    glob (expanded sorted), a PSLCache, or a list of these. A literal path
    that is missing or a glob that matches nothing raises
    FileNotFoundError naming it."""
    entries = list(cache) if isinstance(cache, (list, tuple)) else [cache]
    if not entries:
        raise FileNotFoundError("psl cache list is empty — pass one file, a shard glob, or "
                                "a non-empty list (cli.psl_cache builds them)")
    out: list = []
    for entry in entries:
        if isinstance(entry, PSLCache):
            out.append(entry)
            continue
        entry = str(entry)
        if _glob.has_magic(entry):
            hits = sorted(_glob.glob(entry))
            if not hits:
                raise FileNotFoundError(
                    f"PSL cache glob {entry!r} matches no files — build the shards with "
                    f"cli.psl_cache (--shard i/N) or fix the pattern")
            out.extend(hits)
        elif not os.path.exists(entry):
            raise FileNotFoundError(f"PSL cache {entry} does not exist — build it with "
                                    f"cli.psl_cache or switch to psl: {{mode: psl}}")
        else:
            out.append(entry)
    return out


def cache_starts(n: int, L: int, grid: int) -> list[int]:
    """The cached-crop grid rule. Long clips (n > L): crop starts
    ``range(0, n - L, grid)``; short clips (n < L): zero-pad offsets
    ``range(0, L - n, grid)``; n == L: the identity crop [0]."""
    if n == L:
        return [0]
    return list(range(0, n - L if n > L else L - n, grid))


def _apply_start(wav: np.ndarray, L: int, start: int) -> np.ndarray:
    """The crop (long clip) or zero pad (short clip) at one grid start."""
    n = wav.shape[-1]
    if n >= L:
        return wav[start:start + L]
    out = np.zeros(L, dtype=wav.dtype)
    out[start:start + n] = wav
    return out


def score_crops(clips: Iterable, teacher_fn: Callable[[np.ndarray], np.ndarray], *,
                L: int, grid: int, batch_size: int, classes: Optional[int] = None):
    """Score every grid crop of ``clips`` ((name, wav) pairs) with
    ``teacher_fn((B, L) wav batch) -> (B, C) probs``; yields (name, float16
    (n_starts, C) probs) in clip order as soon as a clip's crops are all
    scored. Crops of different clips share batches; the last batch is
    zero-padded to ``batch_size`` and its pad rows dropped, so the teacher
    sees one shape."""
    if grid <= 0:
        raise ValueError(f"grid must be positive, got {grid}")
    pending: collections.deque = collections.deque()  # [name, n_starts, rows]
    buf: list = []
    owners: list = []

    def flush():
        if not buf:
            return
        k = len(buf)
        batch = np.stack(buf)
        if k < batch_size:
            batch = np.concatenate([batch, np.zeros((batch_size - k,) + batch.shape[1:],
                                                    batch.dtype)])
        probs = np.asarray(teacher_fn(batch))[:k]
        for entry, p in zip(owners, probs):
            entry[2].append(p)
        buf.clear()
        owners.clear()

    def finished():
        while pending and len(pending[0][2]) == pending[0][1]:
            name, _, rows = pending.popleft()
            probs = np.stack(rows)
            if classes is not None:
                probs = probs[:, :classes]
            yield name, probs.astype(np.float16)

    for name, wav in clips:
        starts = cache_starts(wav.shape[-1], L, grid)
        entry = [name, len(starts), []]
        pending.append(entry)
        for s in starts:
            buf.append(_apply_start(wav, L, s))
            owners.append(entry)
            if len(buf) == batch_size:
                flush()
        yield from finished()
    flush()
    yield from finished()


def _cache_attrs(grid, L, sample_rate, classes, teacher_name, shard) -> dict:
    attrs = {"version": CACHE_VERSION, "grid": int(grid), "chunk_length": int(L),
             "sample_rate": int(sample_rate), "classes": int(classes),
             "teacher": str(teacher_name)}
    if shard is not None:
        attrs["shard_index"], attrs["shard_count"] = int(shard[0]), int(shard[1])
    return attrs


def _check_shard(shard):
    if shard is None:
        return None
    si, sn = int(shard[0]), int(shard[1])
    if not 0 <= si < sn:
        raise ValueError(f"shard index must satisfy 0 <= i < n, got {si}/{sn}")
    return si, sn


def score_psl_cache(clips, teacher_fn, *, chunk_length: float = 1.0,
                    grid: int = DEFAULT_GRID, sample_rate: int = 16000,
                    batch_size: int = 256, classes: Optional[int] = None,
                    teacher_name: str = "", shard=None) -> PSLCache:
    """The in-memory build: ``clips`` is a list of (name, wav) pairs (the
    manifest's order); ``shard=(i, n)`` keeps pairs ``i::n``. -> PSLCache
    with the attributes a file build would write."""
    shard = _check_shard(shard)
    clips = list(clips)
    if shard is not None:
        clips = clips[shard[0]::shard[1]]
    L = int(chunk_length * sample_rate)
    entries = dict(score_crops(clips, teacher_fn, L=L, grid=int(grid),
                               batch_size=batch_size, classes=classes))
    n_classes = next(iter(entries.values())).shape[1] if entries else 0
    return PSLCache(_cache_attrs(grid, L, sample_rate, n_classes, teacher_name, shard), entries)


def build_psl_cache(data_frame, teacher_fn, out_path, *, chunk_length: float = 1.0,
                    grid: int = DEFAULT_GRID, sample_rate: int = 16000,
                    batch_size: int = 256, classes: Optional[int] = None,
                    teacher_name: str = "", progress: Optional[Callable[[int, int], None]] = None,
                    shard=None) -> dict:
    """Score every grid crop of every manifest clip (filename/hdf5path
    columns) and write the float16 cache to ``out_path`` (HDF5, one
    dataset per clip, written as soon as the clip is scored).
    ``shard=(i, n)`` scores manifest rows ``i::n`` and stamps the shard
    into the file. -> summary {clips, crops, classes, bytes}."""
    import h5py

    shard = _check_shard(shard)
    L = int(chunk_length * sample_rate)
    df = data_frame.reset_index(drop=True)
    if shard is not None:
        df = df.iloc[shard[0]::shard[1]].reset_index(drop=True)

    def clips():
        for i in range(len(df)):
            row = df.iloc[i]
            fname = row["filename"]
            with h5py.File(row["hdf5path"], "r") as src:
                if fname not in src:
                    raise KeyError(f"waveform key {fname!r} not found in {row['hdf5path']} "
                                   f"while building the PSL cache")
                wav = src[fname][:]
            yield fname, wav
            if progress is not None:
                progress(i + 1, len(df))

    n_crops, n_classes = 0, 0
    with h5py.File(out_path, "w") as out:
        for fname, probs in score_crops(clips(), teacher_fn, L=L, grid=int(grid),
                                        batch_size=batch_size, classes=classes):
            out.create_dataset(fname, data=probs)
            n_crops, n_classes = n_crops + probs.shape[0], probs.shape[1]
        for k, v in _cache_attrs(grid, L, sample_rate, n_classes, teacher_name,
                                 shard).items():
            out.attrs[k] = v
    return {"clips": len(df), "crops": n_crops, "classes": n_classes,
            "bytes": os.path.getsize(out_path)}


class PSLCacheReader:
    """One PSL cache or a shard set (paths, a glob, PSLCaches, or a list of
    them) for crops of ``chunk_length`` samples, validated as one build:
    equal grid/chunk/sample rate/teacher (and classes, where a shard is not
    empty), a complete 0..N-1 shard index set, no clip in two shards.
    ``row(fname, n, rng)`` draws a uniform grid index of a clip of n
    samples -> (start, float32 cached probabilities)."""

    def __init__(self, cache, chunk_length: int, num_classes: int):
        self.sources = resolve_cache_paths(cache)
        self.chunk_length = int(chunk_length)
        self._local = threading.local()
        self._clip_source: dict[str, int] = {}
        infos, shard_ids = [], []
        for si, src in enumerate(self.sources):
            attrs, keys = self._attrs_and_keys(src)
            for key in ("grid", "chunk_length", "classes"):
                if key not in attrs:
                    raise ValueError(f"{self._name(si)} is not a PSL cache (missing attribute "
                                     f"{key!r}); build one with cli.psl_cache")
            infos.append((self._name(si), attrs, bool(keys)))
            if "shard_index" in attrs:
                shard_ids.append((int(attrs["shard_index"]), int(attrs["shard_count"])))
            for fname in keys:
                if fname in self._clip_source:
                    raise ValueError(
                        f"clip {fname!r} appears in two PSL shards "
                        f"({self._name(self._clip_source[fname])} and {self._name(si)}) — the "
                        f"files are not one --shard i/N build; regenerate the shard set")
                self._clip_source[fname] = si
        # compare every shard with a non-empty one: a shard whose stride got
        # no rows stores classes=0
        ref_name, attrs0, _ = next((i for i in infos if i[2]), infos[0])
        for name, attrs, nonempty in infos:
            for key in ["grid", "chunk_length", "sample_rate", "teacher"] + (
                    ["classes"] if nonempty else []):
                if str(attrs0.get(key)) != str(attrs.get(key)):
                    raise ValueError(
                        f"PSL cache shards disagree on {key}: {ref_name} has "
                        f"{attrs0.get(key)}, {name} has {attrs.get(key)} — they are not "
                        f"one build; regenerate the shard set")
        if shard_ids:
            self._check_shard_set(shard_ids)
        if int(attrs0["chunk_length"]) != self.chunk_length:
            raise ValueError(
                f"PSL cache {self._name(0)} was built for chunk_length="
                f"{int(attrs0['chunk_length'])} samples but the training config crops "
                f"{self.chunk_length} — rebuild the cache or fix chunk_length")
        self.grid = int(attrs0["grid"])
        self.classes = int(attrs0["classes"])
        if self.classes > num_classes:
            raise ValueError(f"PSL cache stores {self.classes} classes but targets have "
                             f"{num_classes}")

    def _name(self, si: int) -> str:
        src = self.sources[si]
        return repr(src) if isinstance(src, PSLCache) else str(src)

    @staticmethod
    def _attrs_and_keys(src):
        if isinstance(src, PSLCache):
            return dict(src.attrs), list(src.keys())
        import h5py

        with h5py.File(src, "r") as f:
            return dict(f.attrs), list(f.keys())

    def _check_shard_set(self, shard_ids):
        names = [self._name(i) for i in range(len(self.sources))]
        counts = {n for _, n in shard_ids}
        if len(counts) != 1:
            raise ValueError(f"PSL cache shards come from different --shard N builds "
                             f"({sorted(counts)}) across {names}")
        n = counts.pop()
        indices = [i for i, _ in shard_ids]
        dups = sorted({i for i in indices if indices.count(i) > 1})
        if dups:
            raise ValueError(f"duplicate PSL shard indices {dups} across {names} — the files "
                             f"mix more than one --shard i/{n} build; pass each shard exactly "
                             f"once")
        missing = set(range(n)) - set(indices)
        if missing:
            raise ValueError(f"incomplete PSL shard set: built as {n} shards but indices "
                             f"{sorted(missing)} are absent from {names} — pass every shard "
                             f"(glob or list)")

    def _source(self, si: int):
        src = self.sources[si]
        if isinstance(src, PSLCache):
            return src
        files = getattr(self._local, "files", None)
        if files is None:
            files = self._local.files = {}
        if si not in files:
            import h5py

            files[si] = h5py.File(src, "r")
        return files[si]

    def draw(self, n: int, rng) -> int:
        """The grid index of a random crop of a clip of n samples."""
        return rng.randrange(len(cache_starts(n, self.chunk_length, self.grid)))

    def row(self, fname: str, n: int, gi: int):
        """(grid start, cached probabilities row) of crop ``gi`` (``draw``)
        of one clip of n samples."""
        si = self._clip_source.get(fname)
        if si is None:
            names = [self._name(i) for i in range(len(self.sources))]
            raise KeyError(f"clip {fname!r} has no entry in the PSL cache(s) {names} — "
                           f"{_REBUILD} over this manifest")
        node = self._source(si)[fname]
        starts = cache_starts(n, self.chunk_length, self.grid)
        if node.shape[0] != len(starts):
            raise ValueError(
                f"PSL cache entry for {fname!r} has {node.shape[0]} crop rows but the clip's "
                f"length ({n} samples) implies {len(starts)} on grid {self.grid} — the audio "
                f"changed since the cache was built; rebuild it")
        return starts[gi], np.asarray(node[gi], dtype=np.float32)


class PSLCachedRandomCropHDF5Dataset(WeakRandomCropHDF5Dataset):
    """Random grid-aligned crop + cached teacher target: index -> (wav
    crop, target with ``target[:classes]`` = the cached teacher row of the
    drawn crop, filename). The grid index is drawn (``draw``) from the
    same per-dataset ``random.Random`` the online crop dataset uses.
    ``cache_path``: a file, a glob, a PSLCache or a list of shards
    (PSLCacheReader)."""

    def __init__(self, data_frame, chunk_length: float, num_classes: int, cache_path,
                 sample_rate: int = 16000, rng=None, dtype: str = "float32"):
        super().__init__(data_frame, chunk_length=chunk_length, num_classes=num_classes,
                         sample_rate=sample_rate, rng=rng, dtype=dtype)
        self.reader = PSLCacheReader(cache_path, self.chunk_length, num_classes)

    def draw(self, index: int) -> int:
        return self.reader.draw(self._clip_length(index), self._rng)

    def fetch(self, index: int, drawn=None):
        fname = self._fnames[index]
        target = multihot(self._labels[index], self._num_classes)
        node = self._node(self._paths[index], fname)
        n, L = node.shape[-1], self.chunk_length
        start, probs = self.reader.row(fname, n, drawn)
        data = node[start:start + L] if n > L else _apply_start(node[:], L, start)
        target[: self.reader.classes] = probs
        return _convert(data, self._dtype), target, fname
