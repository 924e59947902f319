"""The port's serving artifacts (uit_mobile_tpu_torch.ckpt.artifact), the mel
kernel as a custom op, cli.export and cli.average, against the JAX
package's on the CPU.

JAX ``models.build`` weights of a small UiT (uit_xxxs, depth 2, outputdim
37) are carried into the port with ``module_from_numpy``; every input is
seeded numpy. Tolerances: an artifact against the forward it was exported
from 1e-6 (measured: bitwise on the CPU), against the JAX package's forward
1e-5 (float32 forwards ~1e-7 apart, tests/test_torch_uit.py); int16
artifacts equal the float32 ones within 1e-6 (the 1/32768 fold is exact);
the kernel artifact's program on the CPU runs the kernel's plain version,
bitwise ``make_forward_fn(use_kernel=True)``; the CLIs' .pt and .npz files
equal the JAX CLIs' key for key, bitwise."""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt import export_serving as jax_export_serving
from uit_mobile_tpu.ckpt import save_artifact as jax_save_artifact
from uit_mobile_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from uit_mobile_tpu.cli.average import main as jax_average_main
from uit_mobile_tpu.cli.export import main as jax_export_main
from uit_mobile_tpu.ops.pipeline import make_forward_fn as jax_make_forward_fn
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, save_numpy_checkpoint
from uit_mobile_tpu_torch.ckpt.artifact import export_serving, load_artifact, save_artifact
from uit_mobile_tpu_torch.cli.average import main as average_main
from uit_mobile_tpu_torch.cli.export import main as export_main
from uit_mobile_tpu_torch.frontend import FrontendConfig, reflect_pad
from uit_mobile_tpu_torch.ops import mel as mel_ops
from uit_mobile_tpu_torch.ops.pipeline import make_forward_fn
from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

torch.set_num_threads(1)
KW = dict(outputdim=37, target_length=102, depth=2)


@pytest.fixture(scope="module")
def carried():
    jcfg = jax_models.get_model_config("uit_xxxs", **KW)
    params, state = jax.tree.map(
        np.asarray, jax.jit(jax_models.build, static_argnums=0)(jcfg, jax.random.key(0)))
    cfg = models.get_model_config("uit_xxxs", **KW)
    return jcfg, params, state, cfg, module_from_numpy(cfg, params, state, "cpu")


@pytest.fixture(scope="module")
def poly(carried):
    """The batch-polymorphic float32 artifact of the carried model."""
    cfg, model = carried[3:]
    return export_serving(cfg, model, device="cpu")


def _wav(b, n=16000, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int16":
        return rng.integers(-3000, 3000, (b, n), dtype=np.int16)
    return (rng.standard_normal((b, n)) * 0.1).astype(np.float32)


def _forward(carried, wav, use_kernel=False, precision="exact"):
    cfg, model = carried[3:]
    return make_forward_fn(cfg, model, use_kernel=use_kernel, precision=precision,
                           top_db_mode="per_sample")(wav).numpy()


def _jax_forward(carried, wav):
    jcfg, params, state = carried[:3]
    return np.asarray(jax_make_forward_fn(jcfg, params, state, use_pallas=False,
                                          top_db_mode="per_sample")(jnp.asarray(wav)))


def test_fixed_batch_matches_forward(carried):
    cfg, model = carried[3:]
    exported = export_serving(cfg, model, batch_size=3, device="cpu")
    wav = _wav(3)
    got = exported.call(wav).numpy()
    assert got.shape == (3, 37) and exported.input_shape == ["3", "16000"]
    np.testing.assert_allclose(got, _forward(carried, wav), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _jax_forward(carried, wav), atol=1e-5, rtol=0)
    with pytest.raises(Exception):  # the batch is part of a fixed-batch program
        exported.call(_wav(4))


def test_polymorphic_batch_two_sizes(carried, poly):
    assert poly.input_shape == ["b", "16000"] and poly.output_shape == ["b", "37"]
    for b in (2, 5):
        wav = _wav(b, seed=b)
        got = poly.call(wav).numpy()
        np.testing.assert_allclose(got, _forward(carried, wav), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, _jax_forward(carried, wav), atol=1e-5, rtol=0)


def test_int16_artifact_matches_float32(carried, poly):
    cfg, model = carried[3:]
    exported = export_serving(cfg, model, batch_size=2, dtype="int16", device="cpu")
    pcm = _wav(2, dtype="int16")
    got = exported.call(pcm).numpy()
    np.testing.assert_allclose(got, poly.call(pcm.astype(np.float32) / 32768.0).numpy(),
                               atol=1e-6, rtol=0)


def test_file_roundtrip_and_meta(carried, poly, tmp_path):
    cfg = carried[3]
    path = tmp_path / "model.uitx"
    save_artifact(path, poly, cfg=cfg, labels={"0": "Speech"}, extra={"note": "test"})
    fn, meta = load_artifact(path)
    assert meta["format"] == "uitx-torch-v1"
    assert meta["input_dtype"] == "float32"
    assert meta["input_shape"] == ["b", "16000"] and meta["output_shape"] == ["b", "37"]
    assert meta["device"] == "cpu" and meta["use_kernel"] is False
    assert meta["torch_version"] == torch.__version__
    assert meta["labels"] == {"0": "Speech"} and meta["extra"] == {"note": "test"}
    assert meta["config"]["__model_config__"] == "UITConfig"
    wav = _wav(4)
    assert torch.equal(fn(wav), poly.call(wav))
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["meta.json", "model.pt2"]
        json.loads(z.read("meta.json").decode())


def test_kernel_artifact_needs_a_fixed_batch(carried):
    cfg, model = carried[3:]
    with pytest.raises(ValueError, match="batch_size"):
        export_serving(cfg, model, use_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        export_serving(cfg, model, dtype="float64", device="cpu")


@pytest.mark.parametrize("B, precision, dtype", [(3, "exact", "float32"),
                                                 (128, "fast", "int16")])
def test_kernel_artifact_holds_the_op(carried, tmp_path, B, precision, dtype):
    """B=3: the row kernel; B=128 (TFB_MIN_BATCH): the transposed one. On
    the CPU the op's plain version runs: bitwise make_forward_fn's."""
    cfg, model = carried[3:]
    exported = export_serving(cfg, model, batch_size=B, precision=precision, dtype=dtype,
                              use_kernel=True, device="cpu")
    ops = [n.args for n in exported.program.graph.nodes
           if n.op == "call_function" and "log_mel_rows" in str(n.target)]
    assert len(ops) == 1 and ops[0][-1] is (B >= mel_ops.TFB_MIN_BATCH)
    path = save_artifact(tmp_path / "k.uitx", exported, cfg=cfg)
    fn, meta = load_artifact(path)
    assert meta["use_kernel"] is True and meta["input_shape"] == [str(B), "16000"]
    wav = _wav(B, dtype=dtype, seed=B)
    got = fn(wav).numpy()
    np.testing.assert_array_equal(got, _forward(carried, wav, use_kernel=True,
                                                precision=precision))
    if precision == "exact":
        np.testing.assert_allclose(got, _jax_forward(carried, wav), atol=1e-5, rtol=0)


def test_ensemble_artifact_is_one_program(carried):
    cfg, model = carried[3:]
    other = models.build(cfg, torch.Generator().manual_seed(3), "cpu")
    exported = export_serving(cfg, [model, other], batch_size=2, device="cpu")
    wav = _wav(2, seed=4)
    want = make_forward_fn(cfg, [model, other], use_kernel=False,
                           top_db_mode="per_sample")(wav).numpy()
    np.testing.assert_allclose(exported.call(wav).numpy(), want, atol=1e-6, rtol=0)


def test_service_from_artifact(carried, poly, tmp_path):
    path = save_artifact(tmp_path / "m.uitx", poly, cfg=carried[3], labels={"0": "a"})
    svc = TaggingService.from_artifact(
        path, ServiceConfig(batch_size=4, warmup=False, max_wait_ms=2.0, dtype="float32"),
        device="cpu")
    try:
        assert svc.artifact_meta["labels"] == {"0": "a"}
        assert svc.cfg.max_seconds == 1
        wavs = [_wav(1, 16000 - 1000 * i, seed=i)[0] for i in range(5)]
        outs = svc.infer_many(wavs)
        for w, o in zip(wavs, outs):
            padded = np.zeros(16000, np.float32)
            padded[: w.shape[0]] = w
            np.testing.assert_allclose(o, poly.call(padded[None])[0].numpy(), atol=1e-6,
                                       rtol=0)
        with pytest.raises(ValueError, match="max_seconds"):
            svc.submit(np.zeros(16001, np.float32))
        # the sealed program is the weights: hot reload refuses
        with pytest.raises(RuntimeError, match="artifact"):
            svc.reload(carried[4])
    finally:
        svc.close()


def test_from_artifact_rejections(carried, poly, tmp_path):
    cfg, model = carried[3:]
    fixed = save_artifact(tmp_path / "fixed.uitx",
                          export_serving(cfg, model, batch_size=2, device="cpu"), cfg=cfg)
    with pytest.raises(ValueError, match="batch-polymorphic"):
        TaggingService.from_artifact(fixed, device="cpu")
    p = save_artifact(tmp_path / "poly.uitx", poly, cfg=cfg)
    with pytest.raises(ValueError, match="dtype"):
        TaggingService.from_artifact(p, ServiceConfig(dtype="int16"), device="cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        TaggingService.from_artifact(p, ServiceConfig(data_parallel=True), device="cpu")
    with pytest.raises(ValueError, match="scan_batches"):
        TaggingService.from_artifact(p, ServiceConfig(scan_batches=4), device="cpu")


def test_jax_artifact_is_refused(carried, tmp_path):
    jcfg, params, state = carried[:3]
    exported = jax_export_serving(jcfg, params, state, batch_size=2, platforms=("cpu",))
    path = jax_save_artifact(tmp_path / "jax.uitx", exported, cfg=jcfg)
    with pytest.raises(ValueError, match="JAX package artifact"):
        load_artifact(path, device="cpu")


def test_cli_artifact_verify(carried, tmp_path):
    cfg, model = carried[3:]
    ckpt = tmp_path / "ckpt.npz"
    save_numpy_checkpoint(ckpt, *carried[1:3], cfg)
    out = tmp_path / "model.uitx"
    assert export_main([str(ckpt), "-o", str(out), "--artifact", "--device", "cpu",
                        "--batch-size", "2", "--kernel", "--verify"]) == 0
    fn, meta = load_artifact(out)
    assert meta["input_shape"] == ["2", "16000"] and meta["use_kernel"] is True
    probs = fn(_wav(2)).numpy()
    assert probs.shape == (2, 37) and ((probs >= 0) & (probs <= 1)).all()


def test_cli_pt_and_average_match_the_jax_clis(carried, tmp_path):
    jcfg, params, state, cfg, _ = carried
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    jax_save_checkpoint(a, params, state, jcfg)
    params_b = jax.tree.map(lambda v: v * 0.5, params)
    jax_save_checkpoint(b, params_b, state, jcfg)
    assert export_main([str(a), "-o", str(tmp_path / "port.pt")]) == 0
    assert jax_export_main([str(a), "-o", str(tmp_path / "jax.pt")]) == 0
    port_sd = torch.load(tmp_path / "port.pt")
    jax_sd = torch.load(tmp_path / "jax.pt")
    assert port_sd.keys() == jax_sd.keys()
    assert all(torch.equal(port_sd[k], jax_sd[k]) for k in jax_sd)
    with pytest.raises(SystemExit, match="ONE weight set"):
        export_main([f"{a},{b}", "-o", str(tmp_path / "x.pt")])
    for suffix in (".npz", ".pt"):
        assert average_main([str(a), str(b), "-o", str(tmp_path / f"avg_port{suffix}")]) == 0
        assert jax_average_main([str(a), str(b), "-o", str(tmp_path / f"avg_jax{suffix}")]) == 0
    with np.load(tmp_path / "avg_port.npz") as p, np.load(tmp_path / "avg_jax.npz") as j:
        keys = [k for k in j.files if k != "__meta__"]
        assert sorted(p.files) == sorted(j.files)
        assert all(np.array_equal(p[k], j[k]) for k in keys)
    port_pt, jax_pt = torch.load(tmp_path / "avg_port.pt"), torch.load(tmp_path / "avg_jax.pt")
    assert port_pt.keys() == jax_pt.keys()
    assert all(torch.equal(port_pt[k], jax_pt[k]) for k in jax_pt)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("transposed", [False, True])
def test_log_mel_rows_opcheck(precision, transposed):
    """torch.library.opcheck holds the op's schema, fake (shape) and
    dispatch; its CPU implementation is the plain version."""
    fe = FrontendConfig()
    wav = torch.from_numpy(_wav(3, seed=1))
    wp = reflect_pad(wav, fe.n_fft // 2).contiguous()
    mats = mel_ops._matrices(fe, False, precision, wav.device)
    args = (wp, *mats, precision, fe.hop_length, transposed)
    torch.library.opcheck(mel_ops.log_mel_rows, args)
    want = mel_ops.plain_log_mel_rows(wp, mats, precision, fe.hop_length)
    got = torch.ops.uit_mobile_tpu_torch.log_mel_rows(*args)
    assert torch.equal(got, want.permute(1, 2, 0) if transposed else want)
