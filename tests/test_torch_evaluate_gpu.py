"""The port's Evaluator on the card: the exact mel kernel (row_exact) in
every batch, against the same Evaluator on the CPU through the kernel's
plain version, on in-memory clips (the card's machine has no h5py or
pandas, so the clips come through an override of ``Evaluator._clips``).

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_evaluate_gpu.py -q -s

Tolerances: probabilities within 1e-3 of the CPU plain path (the JAX
budget through the model, tests/test_pallas_mel.py:67), framewise times
bitwise; fast within 1e-3 of exact on the card; int16 input bitwise
float32's; a two-member ensemble within 1e-6 of the mean of its members.
"""

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import save_checkpoint
from uit_mobile_tpu_torch.data import multihot
from uit_mobile_tpu_torch.data.synthworld import synth_clip, synth_labels
from uit_mobile_tpu_torch.evaluate import Evaluator
from uit_mobile_tpu_torch.frontend import normalize_pcm16
from uit_mobile_tpu_torch.ops import launches
from uit_mobile_tpu_torch.ops import make_framewise_fn

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the mel kernel has no CPU mode")
    return torch.device("cuda")


class MemoryEvaluator(Evaluator):
    """Clips from memory: 'gsc' 1 s clips, 'audioset' 3 s clips of three
    synth clips each; every epoch's (preds, targets, names) is kept."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        rng = np.random.default_rng(0)
        labels = synth_labels(rng, 12, True) + synth_labels(rng, 4, False)
        self.sets = {"gsc": ([synth_clip(rng, lab) for lab in labels], [[lab] for lab in labels])}
        labs = [synth_labels(rng, 3, i % 2 == 0) for i in range(8)]
        self.sets["audioset"] = ([np.concatenate([synth_clip(rng, lab) for lab in ls])
                                  for ls in labs], labs)
        self.epochs = []

    def _clips(self, eval_data, num_classes, basename=True, strong=False):
        clips, labels = self.sets[eval_data]
        conv = (lambda w: w) if self.dtype == "int16" else normalize_pcm16
        return [(conv(c), multihot(lab, num_classes), f"{eval_data}_{i}")
                for i, (c, lab) in enumerate(zip(clips, labels))]

    def _run_epoch(self, dataset, pad_to_target=False):
        out = super()._run_epoch(dataset, pad_to_target)
        self.epochs.append(out)
        return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=2)
    root = tmp_path_factory.mktemp("gpu_eval")
    paths = []
    for seed in (1, 2):
        paths.append(str(root / f"m{seed}.npz"))
        save_checkpoint(paths[-1], models.build(cfg, torch.Generator().manual_seed(seed), "cpu"),
                        cfg)
    return paths


@pytest.mark.gpu
def test_evaluator_on_the_card_matches_the_cpu_plain_path(cuda, ckpts):
    card = MemoryEvaluator(ckpts[0], batch_size=8, num_workers=1, device="cuda")
    cpu = MemoryEvaluator(ckpts[0], batch_size=8, num_workers=1, device="cpu", use_kernel=True)
    for k in launches:
        launches[k] = 0
    for ev in (card, cpu):
        ev.gsc(eval_data="gsc", sweep=True)
        ev.audioset(audioset_eval_data="audioset")
    assert launches["row_exact"] == 2 + 1  # 16 gsc clips, 8 audioset clips at B=8
    for (p_g, t_g, n_g), (p_c, t_c, n_c) in zip(card.epochs, cpu.epochs):
        assert n_g == n_c and np.array_equal(t_g, t_c)
        drift = np.abs(p_g - p_c).max()
        print(f"eval drift card vs CPU plain path: {drift:.3e}")
        assert drift <= 1e-3


@pytest.mark.gpu
def test_fast_int16_and_ensemble_on_the_card(cuda, ckpts):
    exact = MemoryEvaluator(ckpts[0], batch_size=8, num_workers=1, device="cuda")
    exact.gsc(eval_data="gsc")
    ref = exact.epochs[-1][0]
    fast = MemoryEvaluator(ckpts[0], batch_size=8, num_workers=1, device="cuda", fast=True)
    fast.gsc(eval_data="gsc")
    assert np.abs(fast.epochs[-1][0] - ref).max() <= 1e-3
    pcm = MemoryEvaluator(ckpts[0], batch_size=8, num_workers=1, device="cuda", dtype="int16")
    pcm.gsc(eval_data="gsc")
    assert np.array_equal(pcm.epochs[-1][0], ref)
    other = MemoryEvaluator(ckpts[1], batch_size=8, num_workers=1, device="cuda")
    other.gsc(eval_data="gsc")
    ens = MemoryEvaluator(",".join(ckpts), batch_size=8, num_workers=1, device="cuda")
    ens.gsc(eval_data="gsc")
    assert np.abs(ens.epochs[-1][0] - (ref + other.epochs[-1][0]) / 2).max() <= 1e-6


@pytest.mark.gpu
def test_framewise_on_the_card_matches_the_cpu_plain_path(cuda, ckpts):
    from uit_mobile_tpu_torch.cli.common import resolve_model

    rng = np.random.default_rng(3)
    wav = np.stack([normalize_pcm16(np.concatenate([synth_clip(rng, lab) for lab in
                                                    synth_labels(rng, 3, True)]))
                    for _ in range(4)])
    outs = {}
    for dev in ("cuda", "cpu"):
        cfg, model = resolve_model(ckpts[0], device=dev)
        fn = make_framewise_fn(cfg, model, use_kernel=True, top_db_mode="per_sample")
        probs, times = fn(wav)
        outs[dev] = (probs.cpu().numpy(), times)
    assert np.array_equal(outs["cuda"][1], outs["cpu"][1])
    assert np.abs(outs["cuda"][0] - outs["cpu"][0]).max() <= 1e-3
