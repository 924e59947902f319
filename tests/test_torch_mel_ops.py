"""Port mel kernel module (uit_mobile_tpu_torch.ops.mel) on the CPU, where the
wrapper takes each kernel's plain PyTorch version, vs the JAX Pallas kernels
run in interpret mode (as tests/test_pallas_mel.py runs them).

Measured (CPU): plain exact (FP32 DFT, 3-pass bf16 filterbank, as the
Pallas exact kernel) vs Pallas exact <= 5.6e-5 dB at B=3 and 3.1e-4 dB at
B=128 through the transposed kernels, plain fast vs Pallas fast <= 5.5e-5
dB at B=3 and 9.5e-5 dB at B=128; held to 5e-4 dB (exact) and 1e-3 dB
(fast).
The CUDA kernel itself runs only on the card: chip_smoke.py and
tests/test_torch_mel_gpu.py hold it against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu.frontend import FrontendConfig as JaxFrontendConfig
from uit_mobile_tpu.ops import pallas_log_mel
from uit_mobile_tpu_torch.frontend import FrontendConfig, log_mel_spectrogram, reflect_pad
from uit_mobile_tpu_torch.ops import mel as mel_ops
from uit_mobile_tpu_torch.ops.mel import TFB_MIN_BATCH, log_mel, make_frontend_fn

torch.set_num_threads(1)

TOL = {"exact": 5e-4, "fast": 1e-3}


def _wav(B, T=16000, seed=0):
    wav = (np.random.default_rng(seed).standard_normal((B, T)) * 0.1).astype(np.float32)
    pcm = np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)
    return pcm.astype(np.float32) / 32768.0, pcm


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("layout", ["bft", "btf", "tfb"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_plain_versions_match_pallas(precision, layout, dtype):
    f32, pcm = _wav(3, seed=1)
    x = f32 if dtype == "float32" else pcm
    want = np.asarray(pallas_log_mel(jnp.asarray(x), JaxFrontendConfig(),
                                     precision=precision, layout=layout))
    got = log_mel(torch.from_numpy(x), FrontendConfig(), precision=precision,
                  layout=layout).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL[precision], rtol=0)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_transposed_route_matches_pallas_at_batch_128(precision):
    """B=128 takes the transposed ('tfb') kernel in both packages."""
    f32, _ = _wav(TFB_MIN_BATCH, seed=2)
    want = np.asarray(pallas_log_mel(jnp.asarray(f32), JaxFrontendConfig(),
                                     precision=precision, layout="tfb"))
    got = log_mel(torch.from_numpy(f32), FrontendConfig(), precision=precision,
                  layout="tfb").numpy()
    assert got.shape == (101, 64, TFB_MIN_BATCH)
    np.testing.assert_allclose(got, want, atol=TOL[precision], rtol=0)


@pytest.mark.parametrize("mode", ["torch", "per_sample"])
def test_exact_matches_reference_frontend(mode):
    f32, _ = _wav(2, T=40000, seed=3)
    cfg = FrontendConfig(top_db_mode=mode)
    ref = log_mel_spectrogram(torch.from_numpy(f32), cfg)
    got = log_mel(torch.from_numpy(f32), cfg)
    torch.testing.assert_close(got, ref, atol=5e-4, rtol=0)


def test_fast_vs_exact_gates():
    f32, _ = _wav(2, seed=4)
    exact = log_mel(torch.from_numpy(f32), precision="exact")
    fast = log_mel(torch.from_numpy(f32), precision="fast")
    d = (exact - fast).abs()
    assert d.max() < 1.0 and d.mean() < 0.02  # tests/test_pallas_mel.py:54-55


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("B", [2, TFB_MIN_BATCH])
def test_transposed_equals_row_transposed(precision, B):
    f32, pcm = _wav(B, seed=5)
    row = log_mel(torch.from_numpy(pcm), precision=precision, layout="btf")
    tfb = log_mel(torch.from_numpy(pcm), precision=precision, layout="tfb")
    assert torch.equal(tfb, row.permute(1, 2, 0))
    # int16 input is bitwise the normalized float input
    assert torch.equal(tfb, log_mel(torch.from_numpy(f32), precision=precision, layout="tfb"))


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_framing_values_identical(precision):
    f32, _ = _wav(2, seed=6)
    outs = [log_mel(torch.from_numpy(f32), precision=precision, framing=f)
            for f in ("auto", "slices", "gather")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="framing"):
        log_mel(torch.from_numpy(f32), framing="nope")


def test_make_frontend_fn_layouts():
    f32, _ = _wav(2, seed=7)
    wav = torch.from_numpy(f32)
    bft = make_frontend_fn(use_kernel=False)(wav)
    torch.testing.assert_close(make_frontend_fn(use_kernel=False, layout="tfb")(wav),
                               bft.permute(2, 1, 0))
    torch.testing.assert_close(make_frontend_fn(use_kernel=True, layout="btf")(wav),
                               bft.transpose(-1, -2), atol=5e-4, rtol=0)
    # the PSL teacher's layout: the canonical (B, F, T) mel
    torch.testing.assert_close(make_frontend_fn(use_kernel=False, layout="tfb_to_bft")(wav), bft)
    with pytest.raises(ValueError, match="layout"):
        make_frontend_fn(layout="fbt")


def test_cuda_launcher_refuses_cpu_tensors():
    """The launcher never falls back: a CPU tensor is refused, not run plain."""
    mats = mel_ops._matrices(FrontendConfig(), False, "exact", torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mel_ops.cuda_log_mel_rows(torch.zeros(1, 1024), mats, "exact", 160, False)


def test_bf16_split_is_exact_for_pcm():
    """int16 samples split exactly into bf16 hi + lo (the fast path's premise)."""
    x = torch.arange(-32768, 32768, dtype=torch.float32)
    hi, lo = mel_ops._bf16_split(x)
    assert torch.equal(hi.float() + lo.float(), x)


def test_bf16_split3_is_exact_for_pcm_and_float32():
    """_bf16_split3, the exact DFT's pieces: a PCM value splits into hi + mid
    with lo = 0 (so int16 input is bitwise f32/32768 on the exact kernel
    too); any other float32 into hi + mid + lo within 2^-24 of it."""
    pcm = torch.arange(-32768, 32768, dtype=torch.float32)
    for x in (pcm, pcm / 32768.0):
        hi, mid, lo = mel_ops._bf16_split3(x)
        assert torch.equal(lo.float(), torch.zeros_like(x))
        assert torch.equal(hi.float() + mid.float(), x)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1 << 16, generator=g) * torch.exp2(torch.randint(-60, 60, (1 << 16,), generator=g))
    hi, mid, lo = (m.double() for m in mel_ops._bf16_split3(x))
    assert ((hi + mid + lo - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    assert (mid.abs() <= 2.0 ** -8 * hi.abs()).all() and (lo.abs() <= 2.0 ** -16 * hi.abs()).all()


def test_packed_fast_operands_unpack_bitwise():
    """pack_fast_operands only reorders: undoing its tiling gives _matrices's
    bf16 hi/lo back bit for bit."""
    mats = mel_ops._matrices(FrontendConfig(), True, "fast", torch.device("cpu"))
    gpack, fbpack = mats[4:]

    def unpack(flat, rows, k, tile_rows, tile_k):
        t = flat.view(rows // tile_rows, k // tile_k, 2, tile_k // 8, tile_rows // 8, 8, 8)
        t = t.permute(2, 0, 4, 5, 1, 3, 6).reshape(2, rows, k)
        return t[0].t(), t[1].t()

    assert all(torch.equal(a, b) for a, b in zip(
        unpack(gpack, 512, 512, mel_ops.KERNEL_HALF, mel_ops.KERNEL_BK["fast"]), mats[:2]))
    assert all(torch.equal(a, b) for a, b in zip(
        unpack(fbpack, 64, 512, 64, mel_ops.KERNEL_HALF), mats[2:4]))


def test_packed_fast_operands_match_kernel_addressing():
    """Each element sits where mel_kernel<T, L, 3>'s wgmma descriptors look for
    it: G(k, n) in step t = (n // 256) * 16 + k // 32 of gpack, at byte
    (k % 32 // 8) * LBO + (n % 256 // 8) * SBO + (n % 8) * 16 + (k % 8) * 2
    of the step's hi tile (LBO 4096, SBO 128; the lo tile 16 KB later), and
    fb(c, m) in half c // 256 of fbpack at (c % 256 // 8) * 1024 + (m // 8)
    * 128 + (m % 8) * 16 + (c % 8) * 2 (lo 32 KB later)."""
    g_hi, g_lo, fb_hi, fb_lo, gpack, fbpack = mel_ops._matrices(
        FrontendConfig(), False, "fast", torch.device("cpu"))
    k = torch.arange(512)[:, None]
    n = torch.arange(512)[None, :]
    byte = ((n // 256 * 16 + k // 32) * 32768 + (k % 32 // 8) * 4096 + (n % 256 // 8) * 128
            + (n % 8) * 16 + (k % 8) * 2)
    assert torch.equal(gpack[byte // 2], g_hi) and torch.equal(gpack[(byte + 16384) // 2], g_lo)
    c = torch.arange(512)[:, None]
    m = torch.arange(64)[None, :]
    byte = (c // 256) * 65536 + (c % 256 // 8) * 1024 + (m // 8) * 128 + (m % 8) * 16 + (c % 8) * 2
    assert torch.equal(fbpack[byte // 2], fb_hi)
    assert torch.equal(fbpack[(byte + 32768) // 2], fb_lo)


def test_packed_exact_operands_match_kernel_addressing():
    """Each element sits where mel_kernel<T, L, 6>'s wgmma descriptors look
    for it: G(k, n) in step t = (n // 256) * 32 + k // 16 of gpack (3 x 8 KB
    a step), at byte (k % 16 // 8) * LBO + (n % 256 // 8) * SBO + (n % 8) * 16
    + (k % 8) * 2 of the step's hi tile (LBO 4096, SBO 128; mid 8 KB later,
    lo 16 KB later), the pieces _bf16_split3 gives; the filterbank packed as
    for the fast kernel."""
    for pcm16 in (False, True):
        G, _, fb_hi, fb_lo, gpack, fbpack = mel_ops._matrices(
            FrontendConfig(), pcm16, "exact", torch.device("cpu"))
        k = torch.arange(512)[:, None]
        n = torch.arange(512)[None, :]
        byte = ((n // 256 * 32 + k // 16) * 3 * 8192 + (k % 16 // 8) * 4096
                + (n % 256 // 8) * 128 + (n % 8) * 16 + (k % 8) * 2)
        for q, piece in enumerate(mel_ops._bf16_split3(G)):
            assert torch.equal(gpack[(byte + q * 8192) // 2], piece)
        c = torch.arange(512)[:, None]
        m = torch.arange(64)[None, :]
        byte = (c // 256) * 65536 + (c % 256 // 8) * 1024 + (m // 8) * 128 + (m % 8) * 16 + (c % 8) * 2
        assert torch.equal(fbpack[byte // 2], fb_hi)
        assert torch.equal(fbpack[(byte + 32768) // 2], fb_lo)


def test_fast_operands_packed_once_with_matrices():
    """The packed copies are built with _matrices's operands and cached with
    them; the exact operands carry their own (G in three pieces, the same
    filterbank hi/lo)."""
    cpu = torch.device("cpu")
    mats = mel_ops._matrices(FrontendConfig(), False, "fast", cpu)
    assert mel_ops._matrices(FrontendConfig(), False, "fast", cpu) is mats
    assert all(torch.equal(a, b) for a, b in zip(
        mats[4:], mel_ops.pack_operands(mats[:2], mats[2:4], mel_ops.KERNEL_BK["fast"])))
    exact = mel_ops._matrices(FrontendConfig(), False, "exact", cpu)
    assert len(exact) == 6 and exact[0].dtype == torch.float32 and exact[1] is None
    assert exact[4].numel() == 3 * 512 * 512 and torch.equal(exact[5], mats[5])


@pytest.mark.parametrize("pcm16", [False, True])
def test_fast_operands_and_plain_output_unchanged(pcm16):
    """Sharing _matrices and plain_log_mel_rows with the exact path leaves
    the fast path as it was, bit for bit: G (PCM scale folded in) and the
    filterbank split into bf16 hi/lo, both products 3-pass splits."""
    cfg = FrontendConfig()
    f32, pcm = _wav(2, seed=6)
    wp = reflect_pad(torch.from_numpy(pcm if pcm16 else f32), 256)
    G, col_bin = mel_ops._dft_matrices(512, cfg.win_length, cfg.n_freqs)
    scale = np.float32(1.0 / 32768.0) if pcm16 else np.float32(1.0)
    g_hi, g_lo = mel_ops._bf16_split(torch.from_numpy(G * scale))
    fb_hi, fb_lo = mel_ops._bf16_split(torch.from_numpy(mel_ops._fb_rows(cfg, col_bin)))
    mats = mel_ops._matrices(cfg, pcm16, "fast", torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(mats[:4], (g_hi, g_lo, fb_hi, fb_lo)))
    g = mel_ops._tri_dot(wp.unfold(-1, 512, 160).float(), g_hi, g_lo)
    mel = mel_ops._tri_dot(g * g, fb_hi, fb_lo)
    want = 10.0 / np.log(10.0) * torch.log(torch.clamp(mel, min=1e-10))
    assert torch.equal(mel_ops.plain_log_mel_rows(wp, mats, "fast", 160), want)


@pytest.mark.parametrize("seed", range(6))
def test_fast_tolerance_covers_a_float32_summation_order(seed):
    """tolerance_db holds the fast plain version (float32, this machine's
    matmul order) to the float64 sum of the same products, frame 0 of each
    reflect-padded clip included; for 99 % of the values the tolerance is
    within 2e-4 dB of its 1e-3 dB floor."""
    f32, _ = _wav(16, seed=seed)
    wp = reflect_pad(torch.from_numpy(f32), 256)
    mats = mel_ops._matrices(FrontendConfig(), False, "fast", torch.device("cpu"))
    tol = mel_ops.tolerance_db(wp, mats, 160, "fast")
    err = (mel_ops.plain_log_mel_rows(wp, mats, "fast", 160).double()
           - mel_ops.log_mel_rows_float64(wp, mats, 160, "fast")).abs()
    assert (err <= tol).all()
    assert torch.quantile(tol.flatten() - mel_ops.TOL_DB, 0.99) <= 2e-4


def test_fast_tolerance_rejects_a_dropped_pass():
    """A fast product that drops its hi*lo and lo*hi passes (one bf16 pass
    instead of three) falls outside the tolerance."""
    f32, _ = _wav(4, seed=11)
    wp = reflect_pad(torch.from_numpy(f32), 256)
    mats = mel_ops._matrices(FrontendConfig(), False, "fast", torch.device("cpu"))
    one_pass = (torch.zeros_like(mats[1]), torch.zeros_like(mats[3]))
    wrong = mel_ops.plain_log_mel_rows(wp, (mats[0], one_pass[0], mats[2], one_pass[1]),
                                       "fast", 160)
    err = (wrong - mel_ops.plain_log_mel_rows(wp, mats, "fast", 160)).abs()
    assert (err > mel_ops.tolerance_db(wp, mats, 160, "fast")).any()


@pytest.mark.parametrize("seed", range(6))
def test_exact_tolerance_covers_a_float32_summation_order(seed):
    """tolerance_db holds the exact plain version (float32 DFT in this
    machine's matmul order) to the float64 DFT with the same 3-pass
    filterbank, frame 0 of each reflect-padded clip included; for 99 % of
    the values the tolerance is within 2e-4 dB of its 1e-3 dB floor."""
    f32, _ = _wav(16, seed=seed)
    wp = reflect_pad(torch.from_numpy(f32), 256)
    mats = mel_ops._matrices(FrontendConfig(), False, "exact", torch.device("cpu"))
    tol = mel_ops.tolerance_db(wp, mats, 160, "exact")
    err = (mel_ops.plain_log_mel_rows(wp, mats, "exact", 160).double()
           - mel_ops.log_mel_rows_float64(wp, mats, 160, "exact")).abs()
    assert (err <= tol).all()
    assert torch.quantile(tol.flatten() - mel_ops.TOL_DB, 0.99) <= 2e-4


def test_exact_tolerance_rejects_a_dropped_pass():
    """An exact DFT that drops the products of G's mid piece (hm and mm: a
    G of hi + lo) falls outside the exact tolerance."""
    f32, _ = _wav(4, seed=12)
    wp = reflect_pad(torch.from_numpy(f32), 256)
    mats = mel_ops._matrices(FrontendConfig(), False, "exact", torch.device("cpu"))
    hi, _, lo = mel_ops._bf16_split3(mats[0])
    wrong = mel_ops.plain_log_mel_rows(wp, (hi.float() + lo.float(), *mats[1:]), "exact", 160)
    err = (wrong - mel_ops.plain_log_mel_rows(wp, mats, "exact", 160)).abs()
    assert (err > mel_ops.tolerance_db(wp, mats, 160, "exact")).any()
