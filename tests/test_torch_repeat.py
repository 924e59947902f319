"""Training that repeats bitwise, on the CPU: the port's loaders give the
same batches at any ``num_workers``, equal to the JAX package's loader at
one worker (its one defined result: a single pool thread draws in index
order); a stream skipped to a resume point goes on as the whole stream;
a run stopped after an epoch and resumed ends bitwise where the run
without the stop ends; and ``cli.launch 1`` ends bitwise where
``cli.train`` ends."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from uit_mobile_tpu.data import hdf5 as jax_hdf5
from uit_mobile_tpu.data import psl_cache as jax_pc
from uit_mobile_tpu.data import read_tsv_data as jax_read_tsv
from uit_mobile_tpu_torch.data import hdf5
from uit_mobile_tpu_torch.data import psl_cache as pc
from uit_mobile_tpu_torch.data import read_tsv_data
from uit_mobile_tpu_torch.data.synthworld import build_world
from uit_mobile_tpu_torch.train import loop as loop_mod
from uit_mobile_tpu_torch.train import train_from_config

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SR, N_CLIPS, BATCH = 16000, 48, 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """48 clips from 0.4 to 2.5 s (crops and pads), a weak manifest, a
    strong one (one interval a clip, some shorter than the window) and a
    PSL cache of a toy teacher over the weak one."""
    tmp = tmp_path_factory.mktemp("repeat")
    rng = np.random.default_rng(23)
    h5 = tmp / "clips.h5"
    weak, strong = [], []
    with h5py.File(h5, "w") as f:
        for i in range(N_CLIPS):
            n = int(rng.integers(6000, 40000))
            f[f"c_{i}.wav"] = (rng.standard_normal(n) * 3000).astype(np.int16)
            labels = f"{int(rng.integers(0, 527))};{int(rng.integers(527, 537))}"
            weak.append((f"c_{i}.wav", labels, str(h5)))
            lo = float(rng.uniform(0.0, n / SR / 2))
            strong.append((f"c_{i}.wav", labels, str(h5), lo,
                           lo + float(rng.uniform(0.3, 1.5))))
    pd.DataFrame(weak, columns=["filename", "labels", "hdf5path"]).to_csv(
        tmp / "weak.tsv", sep="\t", index=False)
    pd.DataFrame(strong, columns=["filename", "labels", "hdf5path", "from", "to"]).to_csv(
        tmp / "strong.tsv", sep="\t", index=False)
    cache = tmp / "psl.h5"
    pc.build_psl_cache(read_tsv_data(tmp / "weak.tsv"),
                       lambda w: (np.abs(np.asarray(w, np.float32)[:, :527]) % 7.0) / 7.0,
                       cache, grid=1600, batch_size=16, teacher_name="toy")
    return {"weak": tmp / "weak.tsv", "strong": tmp / "strong.tsv", "cache": str(cache)}


KINDS = ["crop", "psl", "chunked", "unlabeled", "strong", "strong_det"]


def dataset(pkg, kind, world, seed=5):
    """One of the datasets that draw (KINDS), from ``pkg``'s classes:
    random crops, PSL-cache grid crops, crops of a strong interval, MAE's
    unlabeled crops, SED windows from the shared stream and index-pure."""
    data, psl, read = ((hdf5, pc, read_tsv_data) if pkg == "port"
                       else (jax_hdf5, jax_pc, jax_read_tsv))
    rng = random.Random(seed)
    if kind == "crop":
        return data.WeakRandomCropHDF5Dataset(read(world["weak"]), chunk_length=1.0,
                                              num_classes=537, rng=rng)
    if kind == "psl":
        return psl.PSLCachedRandomCropHDF5Dataset(read(world["weak"]), 1.0, 537,
                                                  world["cache"], rng=rng)
    if kind == "chunked":
        return data.WeakChunkedHDF5Dataset(read(world["strong"]), num_classes=537,
                                           fixed_length=1.0, rng=rng)
    if kind == "unlabeled":
        return data.UnlabeledRandomChunkedHDF5Dataset(read(world["weak"]), chunk_length=1.0,
                                                      num_classes=537, rng=rng)
    return data.StrongFramewiseHDF5Dataset(read(world["strong"]), 537, n_segments=4,
                                           seg_seconds=0.25, rng=rng,
                                           deterministic=kind == "strong_det")


def loader(pkg, kind, world, workers, seed=9):
    """Shuffled, but the index-pure SED windows in order, as the SED
    trainer's evaluation reads them."""
    data = hdf5 if pkg == "port" else jax_hdf5
    return data.DataLoader(dataset(pkg, kind, world), batch_size=BATCH,
                           shuffle=kind != "strong_det", drop_last=True, num_workers=workers,
                           seed=seed)


def multi(pkg, world, workers):
    data = hdf5 if pkg == "port" else jax_hdf5
    return data.MultiDataLoader(kws=loader(pkg, "crop", world, workers, seed=3),
                                audioset=loader(pkg, "psl", world, workers, seed=4))


@pytest.fixture()
def busy_threads():
    """Threads switch every microsecond, so that draws made on the pool's
    threads would interleave between them."""
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(was)


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if "wav" not in b:  # a MultiDataLoader's batch
            assert a.keys() == b.keys()
            assert_same_batches([a[k] for k in b], [b[k] for k in b])
            continue
        assert a["filenames"] == b["filenames"]
        for k in ("wav", "target", "lengths"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def two_epochs(dl):
    return [b for _ in range(2) for b in dl]


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_loader_batches_at_any_workers_equal_jax_one_worker(world, kind, workers,
                                                            busy_threads):
    want = two_epochs(loader("jax", kind, world, 1))
    assert_same_batches(two_epochs(loader("port", kind, world, workers)), want)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_multi_loader_at_any_workers_equals_jax_one_worker(world, workers, busy_threads):
    """The Trainer's stream: 30 batches, two and a half passes of each child."""
    def take(ml):
        it = iter(ml)
        return [next(it) for _ in range(30)]

    assert_same_batches(take(multi("port", world, workers)), take(multi("jax", world, 1)))


@pytest.mark.parametrize("n", [0, 5, 12, 29])
def test_skip_goes_on_as_the_whole_stream_and_reads_nothing(world, n, monkeypatch):
    """``MultiDataLoader.skip(n)`` -> the batches n.. of the stream that
    took the first n (12 batches a pass), and no item of those n read."""
    it = iter(multi("port", world, 2))
    whole = [next(it) for _ in range(n + 6)]
    skipped, reads = multi("port", world, 2), []
    for child in skipped.loaders.values():
        ds = child.dataset
        monkeypatch.setattr(ds, "fetch",
                            lambda i, d=None, f=ds.fetch: reads.append(i) or f(i, d))
    skipped.skip(n)
    assert reads == []
    it = iter(skipped)
    assert_same_batches([next(it) for _ in range(6)], whole[n:])


@pytest.mark.parametrize("kind", ["crop", "psl", "chunked", "unlabeled", "strong"])
def test_draws_read_each_clip_length_once(world, kind, monkeypatch):
    """A clip's length is read from its header once, however many passes
    draw from it: ``skip`` over two and a half passes (12 batches a pass,
    every clip in each) and a pass more read each clip's length once."""
    dl = loader("port", kind, world, 2)
    ds, reads = dl.dataset, []
    monkeypatch.setattr(ds, "_length", lambda path, fname, f=ds._length:
                        reads.append(fname) or f(path, fname))
    stream = hdf5.MultiDataLoader(only=dl)
    stream.skip(29)
    it = iter(stream)
    for _ in range(12):
        next(it)
    assert len(reads) == len(set(reads)) == len(ds)


def test_items_are_their_draws_read(world):
    """``ds[i]`` is ``fetch(i, draw(i))``, and a dataset whose draws are
    made apart reads the same bits as one that draws where it reads."""
    for kind in KINDS:
        a, b = dataset("port", kind, world), dataset("port", kind, world)
        for i in (3, 0, 47, 3):
            (wa, ta, fa), (wb, tb, fb) = a[i], b.fetch(i, b.draw(i))
            assert fa == fb and np.array_equal(wa, wb) and np.array_equal(ta, tb)


# ------------------------------------------------------------ the Trainer

RECIPE = dict(
    model="uit_xxxs", model_args={"target_length": 102, "depth": 1}, num_classes=537,
    optimizer="AdamW", optimizer_args={"lr": 1e-3, "weight_decay": 5e-8}, loss="BCELoss",
    batch_size=8, chunk_length=1.0, epochs=3, epoch_length=3, warmup_iters=2, early_stop=50,
    valid_every=1, n_saved=2, seed=42, num_workers=1, eval_batch_size=8,
    psl={"model": "MobileNetV2", "pretrained": "missing.npz", "allow_untrained": True},
    wavtransforms={"Shift": {"min_shift": -0.5, "max_shift": 0.5}, "Gain": {"p": 0.5},
                   "PolarityInversion": {"p": 0.5}},
    spectransforms=[{"TimeMasking": {"time_mask_param": 20, "iid_masks": True}},
                    {"FrequencyMasking": {"freq_mask_param": 8, "iid_masks": True}}])


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The recipe cut to uit_xxxs depth 1 on an .npz synthworld, and the
    last.npz and averaged.npz of its run without a stop (one worker)."""
    tmp = tmp_path_factory.mktemp("recipe")
    cfg = dict(RECIPE, outputpath=str(tmp / "exp"),
               **build_world(tmp / "world", seed=42, n_train=24, n_eval=8, store="npz"))
    train_from_config(dict(cfg, outputdir=str(tmp / "whole")), device="cpu")
    return {"tmp": tmp, "cfg": cfg, "whole": tmp / "whole"}


def arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def assert_bitwise(got, want):
    a, b = arrays(got), arrays(want)
    assert a.keys() == b.keys()
    differ = [k for k in b if not np.array_equal(a[k], b[k])]
    assert not differ, f"{len(differ)} arrays differ, first {differ[:3]}"


@pytest.mark.parametrize("how", ["resume", "auto_resume", "workers_2_k2"])
def test_resumed_run_ends_bitwise_where_the_whole_run_ends(recipe, how, monkeypatch):
    """The run stops after epoch 2 (the fault drill, ``UIT_FAULT_EPOCH``),
    then resumes from its last.npz to epoch 3: last.npz and averaged.npz
    bitwise the run without the stop's. ``tests/test_torch_train_loop.py``
    holds that a resume picks up last.npz's epoch, step and optimizer
    count, and that ``auto_resume`` restarts after a crash; not the bits."""
    cfg = dict(recipe["cfg"], outputdir=str(recipe["tmp"] / how))
    if how == "workers_2_k2":
        cfg.update(num_workers=2, steps_per_dispatch=2)
    monkeypatch.setenv("UIT_FAULT_EPOCH", "2")
    if how == "auto_resume":
        train_from_config(dict(cfg, auto_resume=1), device="cpu")
    else:
        with pytest.raises(RuntimeError, match="injected fault after epoch 2"):
            train_from_config(cfg, device="cpu")
        train_from_config(dict(cfg, resume="auto"), device="cpu")
    assert "resumed from" in (Path(cfg["outputdir"]) / "train.log").read_text()
    for name in ("last.npz", "averaged.npz"):
        assert_bitwise(Path(cfg["outputdir"]) / name, recipe["whole"] / name)


def test_resume_without_a_saved_generator_starts_it_from_the_seed(recipe, monkeypatch):
    """A last.npz whose extra holds no generator state (written before it
    was saved) resumes as before: the generator starts from the seed."""
    cfg = dict(recipe["cfg"], outputdir=str(recipe["tmp"] / "old"), epochs=1)
    train_from_config(cfg, device="cpu")
    real_load, real_setup, first = loop_mod.load_training_state, loop_mod.Trainer.setup, []

    def old_format(*args):
        cfg_, extra = real_load(*args)
        return cfg_, {k: v for k, v in extra.items() if k != "generator"}

    def setup(self):
        real_setup(self)
        step = self.train_step

        def recorded(batch, generator=None):
            first.append(generator.get_state().clone())
            return step(batch, generator)

        self.train_step = recorded

    monkeypatch.setattr(loop_mod, "load_training_state", old_format)
    monkeypatch.setattr(loop_mod.Trainer, "setup", setup)
    train_from_config(dict(cfg, epochs=2, resume="auto"), device="cpu")
    assert torch.equal(first[0], torch.Generator().manual_seed(cfg["seed"]).get_state())


def run_cli(argv, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)


def test_launch_1_ends_bitwise_where_cli_train_ends(recipe):
    """``cli.launch 1`` (one gloo rank: the step under ``parallel.rows``)
    at two workers against ``cli.train`` at one: last.npz bitwise."""
    tmp = recipe["tmp"]
    cfg_path = tmp / "launch.yaml"
    cfg_path.write_text(json.dumps(dict(recipe["cfg"], epochs=2)))  # JSON is YAML
    single = run_cli(["uit_mobile_tpu_torch.cli.train", "train", str(cfg_path), "--device",
                      "cpu", "--outputdir", str(tmp / "single")])
    assert single.returncode == 0, single.stdout[-3000:] + single.stderr[-3000:]
    launched = run_cli(["uit_mobile_tpu_torch.cli.launch", "1", "train", str(cfg_path),
                        "--device", "cpu", "--outputdir", str(tmp / "launched"),
                        "--num_workers", "2"])
    assert launched.returncode == 0, launched.stdout[-3000:] + launched.stderr[-3000:]
    assert "multi-host: process 0/1" in launched.stdout
    assert_bitwise(tmp / "launched" / "last.npz", tmp / "single" / "last.npz")
