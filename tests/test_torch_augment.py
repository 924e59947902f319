"""The port's augments (uit_mobile_tpu_torch.augment) against the JAX package
on the CPU. Random draws differ between a JAX key and a torch.Generator, so
mixup is compared with the same lambdas (equal within 1e-7) and the
stochastic transforms are held to the JAX package's invariants
(tests/test_augment.py, tests/test_tfb_train.py): integer mask bins,
widths in bounds, a 'tfb' mask bitwise the 'bft' mask transposed for the
same generator state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu.augment import mixup_tensor as jax_mixup_tensor
from uit_mobile_tpu_torch.augment import (mixup_lengths, mixup_targets, mixup_tensor,
                                          parse_spectransforms, parse_wavtransforms,
                                          sample_mixup_lambdas)
from uit_mobile_tpu_torch.augment.spec import frequency_masking, time_masking
from uit_mobile_tpu_torch.augment.wav import gain, polarity_inversion, shift

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("batch_axis, shape", [(0, (6, 64, 101)), (-1, (101, 64, 6)),
                                               (0, (6, 537))])
def test_mixup_tensor_matches_jax(batch_axis, shape):
    r = np.random.default_rng(0)
    x = r.standard_normal(shape).astype(np.float32)
    lamb = r.beta(0.3, 0.3, size=6).astype(np.float32)
    want = np.asarray(jax_mixup_tensor(jnp.asarray(x), jnp.asarray(lamb), batch_axis=batch_axis))
    got = mixup_tensor(torch.from_numpy(x), torch.from_numpy(lamb), batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    if batch_axis == 0 and len(shape) == 2:
        torch.testing.assert_close(mixup_targets(torch.from_numpy(x), torch.from_numpy(lamb)), got)


def test_mixup_lengths_and_lambdas():
    assert mixup_lengths(torch.tensor([5, 2, 9, 1])).tolist() == [5, 9, 9, 5]
    lam = sample_mixup_lambdas(_gen(0), 256, 0.3)
    assert lam.shape == (256,) and (lam >= 0).all() and (lam <= 1).all()
    assert lam.std() > 0.2  # Beta(0.3, 0.3) is U-shaped
    assert torch.equal(lam, sample_mixup_lambdas(_gen(0), 256, 0.3))  # seeded


def test_shift_rolls_circularly():
    wav = torch.arange(16, dtype=torch.float32)[None, :].repeat(8, 1)
    out = shift(_gen(0), wav, p=1.0)
    for row in out:  # each row a rotation of 0..15
        k = int(row[0])
        assert torch.equal(row, torch.roll(torch.arange(16.0), -k))
    assert torch.equal(shift(_gen(0), wav, p=0.0), wav)


def test_gain_and_polarity():
    wav = torch.ones(64, 100)
    g = gain(_gen(1), wav, p=1.0)
    assert len(torch.unique(torch.round(g[:, 0], decimals=5))) > 10  # per sample
    db = 20 * torch.log10(g[:, 0].abs())
    assert db.min() >= -18.01 and db.max() <= 6.01
    assert (g == g[:, :1]).all()  # one gain per clip
    assert (polarity_inversion(_gen(2), wav, p=1.0) == -1).all()
    half = polarity_inversion(_gen(3), wav, p=0.5)
    assert 0.2 < (half[:, 0] == -1).float().mean() < 0.8


@pytest.mark.parametrize("iid", [True, False])
def test_masks_integer_bins_in_bounds_and_tfb_bitwise_transposed(iid):
    spec = torch.ones(16, 64, 50)
    out = time_masking(_gen(3), spec, time_mask_param=20, iid_masks=iid)
    fout = frequency_masking(_gen(4), spec, freq_mask_param=8, iid_masks=iid)
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0}
    for b in range(16):
        for masked, param in ((torch.nonzero(out[b, 0] == 0).flatten(), 20),
                              (torch.nonzero(fout[b, :, 0] == 0).flatten(), 8)):
            assert masked.numel() < param  # width floor(U[0, param)) < param
            if masked.numel():  # contiguous whole bins
                assert torch.equal(masked, torch.arange(int(masked[0]), int(masked[-1]) + 1))
    assert (out == out[:, :1, :]).all() and (fout == fout[:, :, :1]).all()
    if iid:  # one mask per sample
        assert len({tuple(torch.nonzero(out[b, 0] == 0).flatten().tolist())
                    for b in range(16)}) > 1
    else:
        assert (out == out[:1]).all()
    x = torch.randn(6, 64, 101, generator=_gen(9))
    for fn, param in ((time_masking, 20), (frequency_masking, 8)):
        a = fn(_gen(5), x, param, iid_masks=iid)
        b = fn(_gen(5), x.permute(2, 1, 0), param, iid_masks=iid, layout="tfb")
        assert torch.equal(a, b.permute(2, 1, 0))


def test_parsers_compose():
    wav_fn = parse_wavtransforms({"Shift": {"min_shift": -0.5, "max_shift": 0.5},
                                  "Gain": {"p": 0.5}, "PolarityInversion": {"p": 0.5}})
    spec = [{"TimeMasking": {"time_mask_param": 20}},
            {"FrequencyMasking": {"freq_mask_param": 8}},
            {"FrequencyMasking": {"freq_mask_param": 8}}]
    f_bft, f_tfb = parse_spectransforms(spec), parse_spectransforms(spec, layout="tfb")
    assert f_bft.layout == "bft" and f_tfb.layout == "tfb"
    wav = torch.randn(2, 16000, generator=_gen(0))
    assert wav_fn(_gen(0), wav).shape == wav.shape
    mel = torch.randn(2, 64, 101, generator=_gen(1))
    a = f_bft(_gen(7), mel)
    assert a.shape == mel.shape and (a == 0).any()
    assert torch.equal(a, f_tfb(_gen(7), mel.permute(2, 1, 0)).permute(2, 1, 0))
    # the dict form composes in the same order as the list form
    assert torch.equal(parse_spectransforms({"TimeMasking": {"time_mask_param": 20}})(_gen(2), mel),
                       parse_spectransforms(spec[:1])(_gen(2), mel))
    assert parse_wavtransforms({}) is None and parse_spectransforms([]) is None
    with pytest.raises(ValueError, match="bft.*tfb"):
        parse_spectransforms(spec, layout="btf")
    with pytest.raises(KeyError, match="Reverb"):
        parse_wavtransforms({"Reverb": {}})
