"""Offline PSL in the port (data/psl_cache.py, cli/psl_cache.py, the
Trainer's ``psl: {mode: offline}``) against the JAX package on the CPU.

One tiny world (five eventful clips: short, exact, long) and one
MobileNetV2 teacher (width 0.25, seeded, its BNs calibrated on clips of the
world so that its scores depend on the crop), carried to JAX by
ckpt/convert.py. Bounds:
the port's cache equals the JAX cache within float16 rounding (5e-4, the
JAX test's bound, tests/test_psl_offline.py:90); a cache written by either
package is read by the other to the same crops and targets, bitwise; the
offline step's loss equals the online-PSL step's within 1e-3 (the JAX
bound, tests/test_psl_offline.py:138: the cached targets are float16).
"""

import random

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.data import psl_cache as jax_pc
from uit_mobile_tpu.data import read_tsv_data as jax_read_tsv
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_to_numpy, save_checkpoint
from uit_mobile_tpu_torch.cli.psl_cache import main as cache_main
from uit_mobile_tpu_torch.cli.psl_cache import make_teacher_fn
from uit_mobile_tpu_torch.data import psl_cache as pc
from uit_mobile_tpu_torch.data import read_tsv_data
from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip
from uit_mobile_tpu_torch.models.mobilenetv2 import calibrate_bn

torch.set_num_threads(1)
L, GRID, C_T = 16000, 1600, 527
LENGTHS = [12000, 16000, 20000, 23500, 9000]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psl_offline")
    rng = np.random.default_rng(11)
    h5 = tmp / "as.h5"
    rows = []
    with h5py.File(h5, "w") as f:
        for i, n in enumerate(LENGTHS):
            f[f"as_{i}.wav"] = synth_eventful_clip(rng, eventful_labels(rng), seconds=n / L)
            rows.append((f"as_{i}.wav", f"{int(rng.integers(0, C_T))};530", str(h5)))
    tsv = tmp / "as.tsv"
    pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
        tsv, sep="\t", index=False)
    t_cfg = models.get_model_config("MobileNetV2", outputdim=C_T, width_mult=0.25)
    teacher = models.build(t_cfg, torch.Generator().manual_seed(5), device="cpu")
    calib = [synth_eventful_clip(rng, eventful_labels(rng), seconds=1.0) for _ in range(8)]
    calibrate_bn(t_cfg, teacher, torch.from_numpy(np.stack(calib).astype(np.float32) / 32768))
    t_np = module_to_numpy(teacher)
    teacher_fn = make_teacher_fn(t_cfg, teacher)
    df = read_tsv_data(tsv)
    port_cache = tmp / "port.h5"
    summary = pc.build_psl_cache(df, teacher_fn, port_cache, grid=GRID, batch_size=8,
                                 teacher_name="toy-mbv2")
    jcfg = jax_models.get_model_config("MobileNetV2", outputdim=C_T, width_mult=0.25)
    jp, js = jax.tree.map(jnp.asarray, t_np[0]), jax.tree.map(jnp.asarray, t_np[1])
    jfwd = jax.jit(lambda w: jax_models.apply(jcfg, jp, js, w))
    jax_cache = tmp / "jax.h5"
    jax_pc.build_psl_cache(jax_read_tsv(tsv), lambda w: np.asarray(jfwd(jnp.asarray(w))),
                           jax_cache, grid=GRID, batch_size=8, teacher_name="toy-mbv2")
    return dict(tmp=tmp, h5=h5, tsv=tsv, df=df, port=port_cache, jax=jax_cache,
                summary=summary, teacher=(t_cfg, teacher), teacher_fn=teacher_fn)


@pytest.mark.parametrize("grid", [1, 1600, 3200, 7000])
def test_cache_starts_matches_jax(grid):
    for n in (1, 9000, 15999, 16000, 16001, 17600, 20000, 23500, 160000):
        assert pc.cache_starts(n, L, grid) == jax_pc.cache_starts(n, L, grid), (n, grid)


def test_port_cache_equals_jax_cache(world):
    with h5py.File(world["port"], "r") as a, h5py.File(world["jax"], "r") as b:
        assert set(a.keys()) == set(b.keys()) == {f"as_{i}.wav" for i in range(5)}
        assert {k: str(v) for k, v in a.attrs.items()} == {k: str(v) for k, v in b.attrs.items()}
        for k in b:
            assert a[k].dtype == b[k].dtype == np.float16
            np.testing.assert_allclose(a[k][:].astype(np.float32), b[k][:].astype(np.float32),
                                       atol=5e-4, rtol=0)
    exp = sum(len(pc.cache_starts(n, L, GRID)) for n in LENGTHS)
    assert world["summary"]["crops"] == exp and world["summary"]["clips"] == 5
    # the teacher's scores depend on the crop: neighbouring grid crops differ
    # by more than the bound, so a crop one grid step off would fail it
    with h5py.File(world["port"], "r") as a:
        rows = [a[k][:].astype(np.float32) for k in sorted(a.keys())]
    assert np.concatenate(rows).std(0).mean() > 5e-3
    assert min(np.abs(np.diff(r, axis=0)).max(1).min() for r in rows if len(r) > 1) > 5e-4


def test_in_memory_cache_equals_the_file(world):
    with h5py.File(world["h5"], "r") as src:
        clips = [(f"as_{i}.wav", src[f"as_{i}.wav"][:]) for i in range(5)]
    mem = pc.score_psl_cache(clips, world["teacher_fn"], grid=GRID, batch_size=8,
                             teacher_name="toy-mbv2")
    with h5py.File(world["port"], "r") as f:
        assert {k: str(v) for k, v in mem.attrs.items()} == {
            k: str(v) for k, v in f.attrs.items()}
        for k in f:
            assert np.array_equal(mem[k], f[k][:])
    a = pc.PSLCachedRandomCropHDF5Dataset(world["df"], 1.0, 537, mem, rng=random.Random(3))
    b = pc.PSLCachedRandomCropHDF5Dataset(world["df"], 1.0, 537, str(world["port"]),
                                          rng=random.Random(3))
    # the manifest as rows over an in-memory {filename: PCM} store (no
    # pandas, no h5py)
    store = dict(clips)
    rows = [{"filename": r.filename, "labels": r.labels, "hdf5path": store}
            for r in world["df"].itertuples()]
    c = pc.PSLCachedRandomCropHDF5Dataset(rows, 1.0, 537, mem, rng=random.Random(3))
    assert len(c) == 5
    for i in range(5):
        for x, y, z in zip(a[i], b[i], c[i]):
            assert np.array_equal(x, y) and np.array_equal(x, z)
    with pytest.raises(KeyError, match="in-memory store"):
        pc.PSLCachedRandomCropHDF5Dataset([dict(rows[0], filename="gone.wav")], 1.0, 537,
                                          mem)[0]


@pytest.mark.parametrize("cache", ["port", "jax"])
def test_each_package_reads_the_others_cache(world, cache):
    """The same seed draws the same crops and targets in both readers."""
    path = str(world[cache])
    mine = pc.PSLCachedRandomCropHDF5Dataset(world["df"], 1.0, 537, path,
                                             rng=random.Random(7))
    theirs = jax_pc.PSLCachedRandomCropHDF5Dataset(jax_read_tsv(world["tsv"]), 1.0, 537, path,
                                                   rng=random.Random(7))
    with h5py.File(path, "r") as c:
        for i in range(5):
            for _ in range(3):
                (w1, t1, f1), (w2, t2, f2) = mine[i], theirs[i]
                assert f1 == f2 and np.array_equal(w1, w2) and np.array_equal(t1, t2)
                assert t1[530] == 1.0  # a label past the teacher's classes survives
                rows = np.asarray(c[f1][:], np.float32)
                assert any(np.array_equal(t1[:C_T], r) for r in rows)


def _shards(world, tag, grid=GRID, teacher="toy-mbv2", ids=(0, 1), n=2):
    """Shard files scored one crop a batch: the teacher's top_db clamp
    (torch mode, as in the JAX package) is against its batch's max, so a
    padded crop's scores depend on the crops batched with it, and only
    batches of one make a shard's rows equal to a single build's."""
    paths = []
    for i in ids:
        p = world["tmp"] / f"{tag}.{i}of{n}.h5"
        if not p.exists():
            pc.build_psl_cache(world["df"], world["teacher_fn"], p, grid=grid, batch_size=1,
                               teacher_name=teacher, shard=(i, n))
        paths.append(str(p))
    return paths


def test_shards_union_equals_single_and_reads_the_same(world):
    paths = _shards(world, "cache")
    seen = {}
    for p in paths:
        with h5py.File(p, "r") as f:
            assert f.attrs["shard_count"] == 2
            for k in f:
                assert k not in seen
                seen[k] = f[k][:]
    single_path = world["tmp"] / "single_b1.h5"
    pc.build_psl_cache(world["df"], world["teacher_fn"], single_path, grid=GRID, batch_size=1,
                       teacher_name="toy-mbv2")
    with h5py.File(single_path, "r") as f:
        assert set(seen) == set(f.keys())
        for k, v in seen.items():
            assert np.array_equal(v, f[k][:])
    for spec in (paths, str(world["tmp"] / "cache.*of2.h5")):
        single = pc.PSLCachedRandomCropHDF5Dataset(world["df"], 1.0, 537, str(single_path),
                                                   rng=random.Random(13))
        sharded = pc.PSLCachedRandomCropHDF5Dataset(world["df"], 1.0, 537, spec,
                                                    rng=random.Random(13))
        for i in range(5):
            for x, y in zip(single[i], sharded[i]):
                assert np.array_equal(x, y)
        single = pc.PSLCachedRandomCropHDF5Dataset(world["df"], 1.0, 537, str(world["port"]),
                                                   rng=random.Random(13))


def _ghost(world, tmp):
    extra = tmp / "extra.h5"
    with h5py.File(extra, "w") as f:
        f["ghost.wav"] = np.zeros(16000, np.int16)
    df = world["df"].copy()
    df.loc[len(df)] = {"filename": "ghost.wav", "labels": [1], "hdf5path": str(extra)}
    return pc.PSLCachedRandomCropHDF5Dataset(df, 1.0, 537, str(world["port"]),
                                             rng=random.Random(1))[len(df) - 1]


def _changed(world, tmp):
    h5 = tmp / "changed.h5"
    with h5py.File(h5, "w") as f:
        f["as_3.wav"] = np.zeros(40000, np.int16)  # built at 23500
    df = pd.DataFrame([("as_3.wav", [1], str(h5))], columns=["filename", "labels", "hdf5path"])
    return pc.PSLCachedRandomCropHDF5Dataset(df, 1.0, 537, str(world["port"]),
                                             rng=random.Random(1))[0]


def _dataset(world, cache, chunk=1.0):
    return pc.PSLCachedRandomCropHDF5Dataset(world["df"], chunk, 537, cache,
                                             rng=random.Random(2))


LOUD = {
    "missing clip": (KeyError, "ghost.wav.*rebuild", _ghost),
    "chunk mismatch": (ValueError, "chunk_length",
                       lambda w, t: _dataset(w, str(w["port"]), chunk=2.0)),
    "changed length": (ValueError, "audio changed", _changed),
    "not a cache": (ValueError, "not a PSL cache", lambda w, t: _dataset(w, str(w["h5"]))),
    "incomplete shard set": (ValueError, "incomplete PSL shard set",
                             lambda w, t: _dataset(w, _shards(w, "cache", ids=(0,)))),
    "mixed grid": (ValueError, "disagree on grid",
                   lambda w, t: _dataset(w, _shards(w, "cache", ids=(0,))
                                         + _shards(w, "odd", grid=3200, ids=(1,)))),
    "mixed teacher": (ValueError, "disagree on teacher",
                      lambda w, t: _dataset(w, _shards(w, "cache", ids=(0,))
                                            + _shards(w, "other", teacher="x", ids=(1,)))),
    "duplicate shard": (ValueError, "duplicate PSL shard indices|two PSL shards",
                        lambda w, t: _dataset(w, _shards(w, "cache", ids=(0, 1))
                                              + _shards(w, "again", ids=(1,)))),
    "clip in two files": (ValueError, "two PSL shards",
                          lambda w, t: _dataset(w, [str(w["port"]), str(w["jax"])])),
    "missing file": (FileNotFoundError, "does not exist",
                     lambda w, t: pc.resolve_cache_paths(str(t / "nope.h5"))),
    "empty glob": (FileNotFoundError, "matches no files",
                   lambda w, t: pc.resolve_cache_paths(str(t / "cache.*of4.h5"))),
}


@pytest.mark.parametrize("case", list(LOUD))
def test_failures_are_loud(world, tmp_path, case):
    exc, match, fn = LOUD[case]
    with pytest.raises(exc, match=match):
        fn(world, tmp_path)


def test_offline_step_equals_online_psl_step(world):
    """One flat-PSL step with the teacher against the plain step on the
    cached targets, same crops and weights."""
    from uit_mobile_tpu_torch.ckpt import module_from_numpy
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    t_cfg, teacher = world["teacher"]
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=1)
    init = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(0), "cpu"))
    ds = _dataset(world, str(world["port"]))
    rows = [ds[i] for i in range(4)]
    as_wav, as_cached = np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])
    kws_wav = (np.random.default_rng(8).standard_normal((4, L)) * 0.05).astype(np.float32)
    kws_tgt = np.zeros((4, 537), np.float32)
    kws_tgt[np.arange(4), 527 + np.arange(4)] = 1.0
    wav = torch.from_numpy(np.concatenate([as_wav, kws_wav]))
    # the cached rows are the teacher's scores of the drawn crops
    online = models.apply(t_cfg, teacher, torch.from_numpy(as_wav)).numpy()
    np.testing.assert_allclose(as_cached[:, :C_T], online, atol=5e-4, rtol=0)
    ground = as_cached.copy()
    ground[:, :C_T] = 0.0  # the teacher overwrites these in the online step
    losses = {}
    for mode, target, kw in (
            ("online", np.concatenate([ground, kws_tgt]),
             dict(psl_cfg=t_cfg, psl_model=teacher, psl_split=4)),
            ("offline", np.concatenate([as_cached, kws_tgt]), {})):
        model = module_from_numpy(cfg, *init, device="cpu")
        step = make_train_step(cfg, model, build_optimizer("Adam", 1e-3).init(model), **kw)
        losses[mode] = step({"wav": wav, "target": torch.from_numpy(target)})["total_loss"]
    assert abs(losses["online"].item() - losses["offline"].item()) < 1e-3


def test_cli_builds_the_cache_and_its_shards(world, tmp_path):
    t_cfg, teacher = world["teacher"]
    ckpt = tmp_path / "teacher.npz"
    save_checkpoint(ckpt, teacher, t_cfg)
    out = tmp_path / "cli.h5"
    assert cache_main([str(world["tsv"]), "-t", str(ckpt), "-o", str(out), "--grid", str(GRID),
                       "--batch-size", "8", "--device", "cpu"]) == 0
    with h5py.File(out, "r") as a, h5py.File(world["port"], "r") as b:
        assert set(a.keys()) == set(b.keys())
        for k in b:
            assert np.array_equal(a[k][:], b[k][:])
    assert cache_main([str(world["tsv"]), "-t", str(ckpt), "-o", str(tmp_path / "s.1of2.h5"),
                       "--batch-size", "8", "--shard", "1/2", "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "s.1of2.h5", "r") as f:
        assert (f.attrs["shard_index"], f.attrs["shard_count"]) == (1, 2)
        assert set(f.keys()) == {"as_1.wav", "as_3.wav"}
    for bad in ("4", "2/2"):
        with pytest.raises(SystemExit):
            cache_main([str(world["tsv"]), "-t", "x", "-o", str(tmp_path / "o.h5"),
                        "--shard", bad, "--device", "cpu"])


def test_trainer_offline_mode_trains(world, tmp_path, capsys):
    """cli.train train with psl: {mode: offline}: no teacher is loaded, the
    cached dataset feeds the plain step, the run ends in averaged.npz."""
    import yaml

    from uit_mobile_tpu_torch.cli.train import main as train_main
    from uit_mobile_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(21)

    def split(name, n, pool):
        h5 = tmp_path / f"{name}.h5"
        rows = []
        with h5py.File(h5, "w") as f:
            for i in range(n):
                f[f"{name}_{i}.wav"] = (rng.standard_normal(16000) * 3000).astype(np.int16)
                rows.append((f"{name}_{i}.wav", str(int(rng.choice(pool))), str(h5)))
        tsv = tmp_path / f"{name}.tsv"
        pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
            tsv, sep="\t", index=False)
        return str(tsv)

    config = dict(
        outputpath=str(tmp_path / "exp"), num_classes=537, model="uit_xxxs",
        model_args={"target_length": 102, "depth": 1}, batch_size=8, epochs=1,
        epoch_length=2, warmup_iters=2, chunk_length=1.0, optimizer="AdamW",
        optimizer_args={"lr": 1e-3}, n_saved=1, num_workers=1, valid_every=1, seed=0,
        config_stem="psl_offline", mixup=0.3,
        psl={"mode": "offline", "cache": str(world["tmp"] / "cache.*of2.h5")},
        audioset_train_data=str(world["tsv"]),
        audioset_eval_data=split("aseval", 4, np.arange(0, 527)),
        kws_train_data=split("kwstrain", 8, np.arange(527, 537)),
        kws_test_data=split("kwseval", 4, np.arange(527, 537)))
    _shards(world, "cache")
    path = tmp_path / "offline.yaml"
    path.write_text(yaml.safe_dump(config))
    assert train_main(["train", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.endswith("averaged.npz")
    log = (tmp_path / "exp").rglob("train.log")
    assert "offline PSL: cached teacher targets" in next(log).read_text()
    t = Trainer.__new__(Trainer)
    t.config, t.device = config, torch.device("cpu")
    assert t._load_psl() == (None, None)
