"""Reference PyTorch checkpoints (``.pt``) -> the JAX-layout numpy trees,
counterpart of ``uit_mobile_tpu/ckpt/torch_convert.py``.

Maps the reference repo's state_dict naming (UiT: init_bn/patch_embed/
blocks.N.{norm1,attn,norm2,mlp}/norm/outputlayer; MobileNetV2:
features.N.*) onto the (params, state) trees of numpy arrays that
``ckpt.convert.module_from_numpy`` turns into the port's modules, so the
arrays equal the JAX converter's leaf for leaf.

Key transforms:
- ``Linear.weight`` (out, in) -> kernel (in, out);
- ``Conv2d.weight`` (O, I, kh, kw) -> HWIO (kh, kw, I, O); the UiT
  patch-embed conv flattens (kh, kw) row-major to (kh*kw, O);
- ``time_pos_embed`` (1, D, 1, Tg) -> (Tg, D), ``freq_pos_embed``
  (1, D, Fg, 1) -> (Fg, D), retargeted to the config's grid by
  ``resize_pos_embed`` (slice to shrink, bilinear to grow);
- ``front_end.*`` buffers (filterbank, window) are never loaded;
- BatchNorm running statistics go to the ``state`` tree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mobilenetv2 import layer_specs


def _t(a) -> np.ndarray:
    # a copy: numpy views of a live torch storage would follow later
    # in-place updates of that tensor
    return np.array(a, dtype=np.float32, copy=True)


def load_torch_checkpoint(path) -> dict:
    """Unpickle a .pt checkpoint -> {'state_dict': {key: np.ndarray},
    'config': dict or None}. Takes raw state_dicts and trainer dumps
    ``{'model': sd, 'config': ...}``, whose config may be a dict or a
    wrapper with a ``.dict`` mapping attribute or a ``.dict()`` method."""
    dump = torch.load(path, map_location="cpu", weights_only=False)
    config = None
    if isinstance(dump, dict) and "model" in dump and isinstance(dump["model"], dict):
        config = dump.get("config")
        if config is not None and not isinstance(config, dict):
            config = getattr(config, "dict", None)
            if callable(config):
                config = config()
            if not isinstance(config, dict):
                config = None
        dump = dump["model"]
    sd = {k: v.detach().cpu().numpy() for k, v in dump.items() if hasattr(v, "numpy")}
    return {"state_dict": sd, "config": config}


def resize_pos_embed(emb: np.ndarray, target_len: int) -> np.ndarray:
    """(L, D) -> (target_len, D): a prefix slice to shrink, bilinear
    interpolation along L (align_corners=False) to grow, as the reference's
    change_pos_embedding does."""
    L, D = emb.shape
    if target_len <= L:
        return emb[:target_len]
    scale = L / target_len
    out = np.empty((target_len, D), dtype=emb.dtype)
    for i in range(target_len):
        src = min(max((i + 0.5) * scale - 0.5, 0.0), L - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, L - 1)
        w = src - lo
        out[i] = (1 - w) * emb[lo] + w * emb[hi]
    return out


def _linear(sd, pre, bias=True) -> dict:
    p = {"kernel": _t(sd[pre + ".weight"]).T.copy()}
    if bias:
        p["bias"] = _t(sd[pre + ".bias"])
    return p


def _norm(sd, pre) -> dict:
    return {"scale": _t(sd[pre + ".weight"]), "bias": _t(sd[pre + ".bias"])}


def uit_params_from_torch_state_dict(sd: dict, cfg) -> tuple[dict, dict]:
    """Reference UITBase state_dict -> (params, state) numpy trees."""
    D, ps = cfg.embed_dim, cfg.patch_size
    params: dict = {}
    state: dict = {}
    if "init_bn.1.weight" in sd:
        params["init_bn"] = _norm(sd, "init_bn.1")
        state["init_bn"] = {"mean": _t(sd["init_bn.1.running_mean"]),
                            "var": _t(sd["init_bn.1.running_var"])}
    w = _t(sd["patch_embed.proj.weight"])  # (D, 1, ps, ps)
    params["patch_embed"] = {"kernel": w.reshape(D, ps * ps).T.copy(),
                             "bias": _t(sd["patch_embed.proj.bias"])}
    params["cls_token"] = _t(sd["cls_token"])
    params["token_pos_embed"] = _t(sd["token_pos_embed"])
    fg, tg = cfg.grid_size
    tpe = _t(sd["time_pos_embed"])[0, :, 0, :].T  # (Tg, D)
    fpe = _t(sd["freq_pos_embed"])[0, :, :, 0].T  # (Fg, D)
    params["time_pos_embed"] = tpe if tpe.shape[0] == tg else resize_pos_embed(tpe, tg)
    params["freq_pos_embed"] = fpe if fpe.shape[0] == fg else resize_pos_embed(fpe, fg)
    blocks = []
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        blk = {
            "norm1": _norm(sd, pre + "norm1"),
            "attn": {"qkv": _linear(sd, pre + "attn.qkv", bias=pre + "attn.qkv.bias" in sd),
                     "proj": _linear(sd, pre + "attn.proj")},
            "norm2": _norm(sd, pre + "norm2"),
            "mlp": {"fc1": _linear(sd, pre + "mlp.fc1"), "fc2": _linear(sd, pre + "mlp.fc2")},
        }
        if pre + "ls1.gamma" in sd:
            blk["ls1"] = {"gamma": _t(sd[pre + "ls1.gamma"])}
            blk["ls2"] = {"gamma": _t(sd[pre + "ls2.gamma"])}
        blocks.append(blk)
    params["blocks"] = blocks
    params["norm"] = _norm(sd, "norm")
    params["head_norm"] = _norm(sd, "outputlayer.0")
    params["head"] = _linear(sd, "outputlayer.1")
    return params, state


def uit_torch_state_dict_from_params(params: dict, state: dict, cfg) -> dict:
    """The inverse: (params, state) trees -> reference-named torch-layout
    arrays (export to the reference ecosystem, round-trip tests)."""
    ps, D = cfg.patch_size, cfg.embed_dim
    a = np.asarray
    sd: dict[str, np.ndarray] = {}

    def put_linear(pre, p):
        sd[pre + ".weight"] = a(p["kernel"]).T
        if "bias" in p:
            sd[pre + ".bias"] = a(p["bias"])

    def put_norm(pre, p):
        sd[pre + ".weight"], sd[pre + ".bias"] = a(p["scale"]), a(p["bias"])

    if "init_bn" in params:
        put_norm("init_bn.1", params["init_bn"])
        sd["init_bn.1.running_mean"] = a(state["init_bn"]["mean"])
        sd["init_bn.1.running_var"] = a(state["init_bn"]["var"])
    sd["patch_embed.proj.weight"] = a(params["patch_embed"]["kernel"]).T.reshape(D, 1, ps, ps)
    sd["patch_embed.proj.bias"] = a(params["patch_embed"]["bias"])
    sd["cls_token"] = a(params["cls_token"])
    sd["token_pos_embed"] = a(params["token_pos_embed"])
    sd["time_pos_embed"] = a(params["time_pos_embed"]).T[None, :, None, :]
    sd["freq_pos_embed"] = a(params["freq_pos_embed"]).T[None, :, :, None]
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        put_norm(pre + "norm1", blk["norm1"])
        put_linear(pre + "attn.qkv", blk["attn"]["qkv"])
        put_linear(pre + "attn.proj", blk["attn"]["proj"])
        put_norm(pre + "norm2", blk["norm2"])
        put_linear(pre + "mlp.fc1", blk["mlp"]["fc1"])
        put_linear(pre + "mlp.fc2", blk["mlp"]["fc2"])
        if "ls1" in blk:
            sd[pre + "ls1.gamma"] = a(blk["ls1"]["gamma"])
            sd[pre + "ls2.gamma"] = a(blk["ls2"]["gamma"])
    put_norm("norm", params["norm"])
    put_norm("outputlayer.0", params["head_norm"])
    put_linear("outputlayer.1", params["head"])
    return sd


def _mobilenetv2_keys(cfg):
    """Per features entry: the (conv weight key, bn prefix) of each of its
    conv+BN pairs in the reference's flat ``features.N`` Sequential (entries
    0 and the last: _ConvBNReLU ``.0``/``.1``; the inverted residuals:
    ``conv.J.0``/``conv.J.1`` _ConvBNReLUs, then a plain conv and bn)."""
    out = []
    for idx, spec in enumerate(layer_specs(cfg)):
        base = f"features.{idx}"
        if spec[0] == "convbnrelu":
            out.append((spec[0], [(f"{base}.0.weight", f"{base}.1")]))
            continue
        n_relu = 2 if spec[4] != 1 else 1
        pairs = [(f"{base}.conv.{j}.0.weight", f"{base}.conv.{j}.1") for j in range(n_relu)]
        pairs.append((f"{base}.conv.{n_relu}.weight", f"{base}.conv.{n_relu + 1}"))
        out.append((spec[0], pairs))
    return out


def mobilenetv2_params_from_torch_state_dict(sd: dict, cfg) -> tuple[dict, dict]:
    """Reference MobileNetV2 state_dict -> (params, state) numpy trees
    (conv kernels HWIO, as in the JAX package)."""

    def conv_bn(conv_key, bn_key):
        p = {"conv": {"kernel": _t(sd[conv_key]).transpose(2, 3, 1, 0).copy()},
             "bn": _norm(sd, bn_key)}
        s = {"bn": {"mean": _t(sd[bn_key + ".running_mean"]),
                    "var": _t(sd[bn_key + ".running_var"])}}
        return p, s

    feats_p, feats_s = [], []
    for kind, pairs in _mobilenetv2_keys(cfg):
        done = [conv_bn(*pair) for pair in pairs]
        if kind == "convbnrelu":
            feats_p.append(done[0][0])
            feats_s.append(done[0][1])
        else:
            feats_p.append({"layers": [p for p, _ in done]})
            feats_s.append({"layers": [s for _, s in done]})
    params = {"features": feats_p, "classifier": _linear(sd, "classifier.1")}
    return params, {"features": feats_s}


def mobilenetv2_torch_state_dict_from_params(params: dict, state: dict, cfg) -> dict:
    """The inverse MobileNetV2 mapping -> reference torch naming."""
    a = np.asarray
    sd: dict[str, np.ndarray] = {}
    for idx, (kind, pairs) in enumerate(_mobilenetv2_keys(cfg)):
        p, s = params["features"][idx], state["features"][idx]
        layers = [(p, s)] if kind == "convbnrelu" else list(zip(p["layers"], s["layers"]))
        for (conv_key, bn_key), (lp, ls) in zip(pairs, layers):
            sd[conv_key] = a(lp["conv"]["kernel"]).transpose(3, 2, 0, 1)
            sd[bn_key + ".weight"] = a(lp["bn"]["scale"])
            sd[bn_key + ".bias"] = a(lp["bn"]["bias"])
            sd[bn_key + ".running_mean"] = a(ls["bn"]["mean"])
            sd[bn_key + ".running_var"] = a(ls["bn"]["var"])
    sd["classifier.1.weight"] = a(params["classifier"]["kernel"]).T
    sd["classifier.1.bias"] = a(params["classifier"]["bias"])
    return sd
