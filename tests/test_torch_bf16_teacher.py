"""``compute_dtype: bfloat16`` in the port's MobileNetV2 teacher
(models/mobilenetv2.py) against the JAX package's bfloat16 on the CPU.

The port convolves float32 copies of bfloat16-rounded operands, the JAX
conv's preferred_element_type=float32. Tolerances: the port's bfloat16
probabilities within 2e-3 of JAX's bfloat16; against the port's float32
drift > 0 (bfloat16 engaged) and <= 5e-3, the JAX budget
(tests/test_mobilenetv2.py:172).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_to_numpy

torch.set_num_threads(1)
VS_JAX, DRIFT = 2e-3, 5e-3


def _bf16(cfg):
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


def _livened_teacher(width_mult=0.25, seed=0):
    """MobileNetV2 with random unit-gain BN affines and statistics: at its
    init every BN is the identity and the activations collapse (sigmoid 0.5
    everywhere), which would hide any dtype effect (the JAX test's
    _liven)."""
    cfg = models.get_model_config("MobileNetV2", outputdim=17, width_mult=width_mult)
    model = models.build(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("bn.scale"):
                t.uniform_(0.8, 1.2, generator=g)
            elif name.endswith("bn.bias"):
                t.normal_(0.0, 0.3, generator=g)
            elif name.endswith("bn.mean"):
                t.normal_(0.0, 0.5, generator=g)
            elif name.endswith("bn.var"):
                t.uniform_(0.3, 1.5, generator=g)
    return cfg, model


def test_teacher_bf16_matches_jax():
    cfg, model = _livened_teacher()
    params, state = module_to_numpy(model)
    jcfg = jax_models.get_model_config("MobileNetV2", outputdim=17, width_mult=0.25)
    wav = (np.random.default_rng(5).standard_normal((1, 16000)) * 0.1).astype(np.float32)
    got = models.apply(_bf16(cfg), model, torch.from_numpy(wav))
    f32 = models.apply(cfg, model, torch.from_numpy(wav))
    assert f32.std().item() > 0.01  # livened: the outputs vary
    want = np.asarray(jax_models.apply(_bf16(jcfg), jax.tree.map(jnp.asarray, params),
                                       jax.tree.map(jnp.asarray, state), jnp.asarray(wav)))
    vs_jax, drift = np.abs(got.numpy() - want).max(), (got - f32).abs().max().item()
    assert vs_jax <= VS_JAX and 0 < drift <= DRIFT, (vs_jax, drift)
    fw, _ = models.apply_framewise(_bf16(cfg), model, torch.from_numpy(wav))
    assert torch.isfinite(fw).all()


def test_psl_compute_dtype_reaches_the_teacher():
    """psl: {compute_dtype: bfloat16} sets the teacher's config."""
    from uit_mobile_tpu_torch.train.loop import Trainer

    t = Trainer.__new__(Trainer)  # no output directory
    t.config = {"psl": {"model": "MobileNetV2", "pretrained": "missing.npz",
                        "allow_untrained": True, "compute_dtype": "bfloat16"}}
    t.device = torch.device("cpu")
    cfg, model = t._load_psl()
    assert cfg.compute_dtype == "bfloat16" and not any(
        p.requires_grad for p in model.parameters())
