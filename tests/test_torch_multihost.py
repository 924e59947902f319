"""Multi-process training of the port on the CPU: gloo ranks in child
processes run the Trainer, SED training and MAE pretraining with a
``multihost:`` key (as ``tests/test_multihost_trainer.py`` runs the JAX
package's), and ``uit_mobile_tpu_torch.cli.launch`` drives the CLI with
rank-prefixed output and coordinated restarts (the UIT_FAULT_EPOCH drill).
What is pinned: the ranks announce the data-parallel mesh; every rank takes
the same decisions (the same validation scores); rank 0 alone writes
checkpoints, ``last.npz`` and ``averaged.npz``, and rank 1 logs to
``train.rank1.log``; a run restarted after a fault resumes from
``last.npz`` and ends at the same epoch as an unbroken run. Also the
policies of ``tests/test_multihost.py:89-160``: ``dp_placement``,
``initialize_from_config``, ``host_local_batch_slice``, and a rank whose
peer never arrives raising within its deadline. Every child process is
joined with a deadline and killed after it."""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from test_multihost_trainer import _make_sed_world, _make_world
from test_torch_parallel import REPO, _free_port, spawn_ranks
from uit_mobile_tpu_torch.parallel import (data_parallel_forward, dp_placement, make_mesh,
                                           replicate_tree, shard_batch)
from uit_mobile_tpu_torch.parallel import multihost

PRELUDE = textwrap.dedent("""
    import json, os, sys
    rank, nproc, port, datadir, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], sys.argv[5])
    import torch
    torch.set_num_threads(1)
    multihost = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
                     process_id=rank)
""")

TRAIN_WORKER = PRELUDE + textwrap.dedent("""
    from uit_mobile_tpu_torch.train.loop import train_from_config

    env = json.load(open(os.path.join(datadir, "env.json")))
    out = train_from_config(dict(
        multihost=multihost, outputpath=outdir, num_classes=537, model="uit_xxxs",
        model_args={"target_length": 102, "depth": 1}, batch_size=8, epochs=2,
        epoch_length=2, warmup_iters=2, chunk_length=1.0, mixup=0.2,
        psl={"model": "MobileNetV2", "pretrained": "/nonexistent.npz",
             "allow_untrained": True, "outputdim": 527},
        optimizer="AdamW", optimizer_args={"lr": 1e-3, "weight_decay": 1e-8},
        early_stop=10, n_saved=2, num_workers=1, eval_batch_size=8, valid_every=1,
        seed=0, config_stem="mh", **env), device="cpu")
    print(f"DONE {rank} {out}", flush=True)
""")

SED_WORKER = PRELUDE + textwrap.dedent("""
    from uit_mobile_tpu_torch.train.sed import train_sed_from_config

    out = train_sed_from_config(dict(
        multihost=multihost, outputpath=outdir, num_classes=10, model="uit_xxxs",
        model_args={"target_length": 102, "depth": 1},
        strong_train_data=os.path.join(datadir, "sed.tsv"),
        strong_eval_data=os.path.join(datadir, "sed.tsv"), basename=False, batch_size=8,
        epochs=2, epoch_length=2, warmup_iters=2, optimizer="AdamW",
        optimizer_args={"lr": 1e-3}, num_workers=1, seed=0, config_stem="mhsed"),
        device="cpu")
    print(f"DONE {rank} {out}", flush=True)
""")


def _run_workers(tmp_path, src, datadir):
    worker = tmp_path / "worker.py"
    worker.write_text(src)
    outdirs = [tmp_path / f"exp{r}" for r in range(2)]
    port = _free_port()
    outs = spawn_ranks(lambda r: [sys.executable, str(worker), str(r), "2", str(port),
                                  str(datadir), str(outdirs[r])], 2)
    for r, out in enumerate(outs):
        assert f"DONE {r}" in out, out
    return outs, outdirs


def _last_epoch(path) -> int:
    from uit_mobile_tpu_torch.ckpt.io import load_checkpoint

    return int(load_checkpoint(path)[3]["epoch"])


def test_two_process_trainer(tmp_path):
    datadir = tmp_path / "data"
    datadir.mkdir()
    (datadir / "env.json").write_text(json.dumps(_make_world(datadir)))
    outs, outdirs = _run_workers(tmp_path, TRAIN_WORKER, datadir)
    assert "data-parallel over 2 devices" in outs[0]
    assert re.search(r"multi-host: process 1/2", outs[1]), outs[1]

    def scores(text):
        return re.findall(r"Validation Results - Epoch : (\S+)\s+.*?mAP (\d\.\d+)", text)

    s0, s1 = scores(outs[0]), scores(outs[1])
    assert s0 and len(s0) >= 2, outs[0]
    assert s1 == s0[: len(s1)], (s0, s1)  # rank 1 skips the averaged model's validation
    rank0 = sorted(p.name for p in outdirs[0].rglob("*.npz"))
    assert "averaged.npz" in rank0 and "last.npz" in rank0, rank0
    assert sorted(outdirs[1].rglob("*.npz")) == []
    assert sorted(outdirs[1].rglob("train.rank1.log"))
    last = next(outdirs[0].rglob("last.npz"))
    assert _last_epoch(last) == 2


def test_two_process_sed(tmp_path):
    datadir = tmp_path / "data"
    datadir.mkdir()
    _make_sed_world(datadir)
    outs, outdirs = _run_workers(tmp_path, SED_WORKER, datadir)
    assert "data-parallel over 2 devices" in outs[0]

    def scores(text):
        return re.findall(r"segF1 micro (\d\.\d+) macro (\d\.\d+)", text)

    assert scores(outs[0]) and scores(outs[0]) == scores(outs[1])
    assert sorted(p.name for p in outdirs[0].rglob("*.npz"))
    assert sorted(outdirs[1].rglob("*.npz")) == []


def _launch(argv, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "uit_mobile_tpu_torch.cli.launch", *argv],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_launch_pretrain(tmp_path):
    """2 ranks of ``cli.train pretrain``: coordinator wiring, rank-prefixed
    output, the same per-epoch losses on both ranks, rank 0's artifact."""
    import h5py
    import pandas as pd
    import yaml

    rng = np.random.default_rng(0)
    rows = []
    with h5py.File(tmp_path / "u.h5", "w") as f:
        for i in range(8):
            f[f"u_{i}.wav"] = (rng.standard_normal(14000) * 3000).astype(np.int16)
            rows.append((f"u_{i}.wav", "0", str(tmp_path / "u.h5")))
    pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
        tmp_path / "unlab.tsv", sep="\t", index=False)
    cfg = dict(model="uit_xxxs", model_args={"target_length": 102, "depth": 1},
               decoder_depth=1, train_data=str(tmp_path / "unlab.tsv"), chunk_length=1.0,
               batch_size=8, epochs=2, epoch_length=1, warmup_iters=1, num_workers=1, seed=0,
               outputpath=str(tmp_path / "exp"))
    (tmp_path / "mh.yaml").write_text(yaml.safe_dump(cfg))
    proc = _launch(["2", "pretrain", str(tmp_path / "mh.yaml"), "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[rank 0]" in proc.stdout and "[rank 1]" in proc.stdout
    losses = [re.findall(rf"\[rank {r}\] .*MAE epoch \d+: loss (\d\.\d+)", proc.stdout)
              for r in range(2)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert (tmp_path / "exp" / "mae" / "uit_xxxs" / "mae_pretrained.npz").exists()


def test_launch_auto_resume_after_a_fault(tmp_path):
    """Rank 1 crashes after epoch 1 (UIT_FAULT_EPOCH); the launcher takes
    both ranks down and relaunches them with --resume auto; the run resumes
    from last.npz at epoch 2 and ends where an unbroken run ends."""
    import yaml

    datadir = tmp_path / "data"
    datadir.mkdir()
    cfg = dict(num_classes=537, model="uit_xxxs", model_args={"target_length": 102, "depth": 1},
               batch_size=8, epochs=2, epoch_length=2, warmup_iters=2, chunk_length=1.0,
               optimizer="AdamW", optimizer_args={"lr": 1e-3}, early_stop=10, n_saved=2,
               num_workers=1, eval_batch_size=8, valid_every=1, seed=0, config_stem="mhar",
               outputpath=str(tmp_path / "exp"), **_make_world(datadir))
    (tmp_path / "mhar.yaml").write_text(yaml.safe_dump(cfg))
    proc = _launch(["2", "train", str(tmp_path / "mhar.yaml"), "--device", "cpu",
                    "--auto-resume", "1"], {"UIT_FAULT_EPOCH": "1", "UIT_FAULT_RANK": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "injected fault after epoch 1" in proc.stdout
    assert "coordinated restart" in proc.stderr, proc.stderr
    assert re.search(r"resumed from .*last\.npz at epoch 2", proc.stdout), proc.stdout
    run_dirs = list((tmp_path / "exp" / "mhlaunch").iterdir())
    assert len(run_dirs) == 1, run_dirs
    assert (run_dirs[0] / "averaged.npz").exists()
    assert _last_epoch(run_dirs[0] / "last.npz") == cfg["epochs"]  # as an unbroken run


def test_dp_placement_policy(monkeypatch):
    """One process: the largest dividing count of its devices (1 -> no
    mesh). A process group: every dim must divide by the rank count."""
    cpu8 = ["cpu"] * 8
    mesh, data_sh, repl = dp_placement([16, 8], devices=cpu8)
    assert mesh.size == 8 and data_sh.spec != repl.spec
    assert dp_placement([12, 4], devices=cpu8)[0].size == 4
    assert dp_placement([7], devices=cpu8)[0].size == 7
    assert dp_placement([1], devices=cpu8) == (None, None, None)
    assert dp_placement([16]) == (None, None, None)  # one device
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="divisible by the global"):
        dp_placement([12, 5])
    mesh, _, _ = dp_placement([16, 8])
    assert mesh.spans_processes


def test_initialize_from_config_and_refusals(monkeypatch):
    from uit_mobile_tpu_torch.parallel.multihost import initialize, initialize_from_config

    with pytest.raises(ValueError, match="unknown multihost config keys"):
        initialize_from_config({"coordinator": "x"})
    initialize_from_config(None)  # falsy -> no-op
    initialize_from_config(False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        initialize_from_config(True, device="cpu")
    initialize(device="cpu")  # best effort: one process, nothing to join
    assert not multihost.is_initialized()


def test_host_local_batch_slice_math(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    slices = []
    for i in range(4):
        monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
        slices.append(multihost.host_local_batch_slice(16))
    assert [(s.start, s.stop) for s in slices] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError, match="divide"):
        multihost.host_local_batch_slice(7)


def test_a_missing_peer_raises_within_the_deadline(tmp_path):
    """Rank 0 of 2 waits for a rank 1 that never starts: it must raise after
    its 5 s rendezvous timeout, not hang."""
    port = _free_port()
    src = textwrap.dedent(f"""
        from uit_mobile_tpu_torch.parallel import multihost
        try:
            multihost.initialize("127.0.0.1:{port}", 2, 0, strict=True, device="cpu",
                                 timeout=5)
        except RuntimeError as e:
            print("RAISED", type(e.__cause__ or e).__name__)
    """)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert "RAISED" in out.stdout, out.stdout + out.stderr
    assert time.monotonic() - t0 < 90


def test_data_parallel_forward_refusals_and_shards():
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.ops.pipeline import make_forward_fn

    cfg = models.get_model_config("uit_xxxs", outputdim=11, target_length=102, depth=1)
    model = models.build(cfg, torch.Generator().manual_seed(2), device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    wav = torch.from_numpy((np.random.default_rng(3).standard_normal((8, 16000)) * 0.1)
                           .astype(np.float32))
    shards = shard_batch(mesh, {"wav": wav})
    assert len(shards) == 4 and all(torch.equal(s["wav"], wav[2 * i:2 * i + 2])
                                    for i, s in enumerate(shards))
    assert len(replicate_tree(mesh, model)) == 4
    want = make_forward_fn(cfg, model)(wav)
    # the plain forward with the batch-global clamp: the shards reduce it together
    got = data_parallel_forward(make_forward_fn(cfg, model), mesh)(wav)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        data_parallel_forward(make_forward_fn(cfg, model), mesh)(wav[:3])
    per_sample = make_forward_fn(cfg, model, use_kernel=True, top_db_mode="per_sample")
    torch.testing.assert_close(data_parallel_forward(per_sample, mesh)(wav), per_sample(wav),
                               atol=2e-5, rtol=0)
    # the kernel's route (its plain version here) keeps the batch-global
    # clamp too, where JAX's shard_map route refuses it: with rows far more
    # than top_db (120 dB) below the loudest on the first shard, a clamp per
    # shard would give other probabilities
    quiet = wav * torch.tensor([1e-3] * 2 + [300.0] * 6)[:, None]
    kernel = make_forward_fn(cfg, model, use_kernel=True)
    want = kernel(quiet)
    torch.testing.assert_close(data_parallel_forward(kernel, mesh)(quiet), want,
                               atol=2e-5, rtol=0)
    assert (kernel(quiet[:2]) - want[:2]).abs().max() > 1e-3  # the clamp bites
