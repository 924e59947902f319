"""Deployable serving artifacts: ``torch.export`` programs in a ``.uitx`` zip.

Counterpart of ``uit_mobile_tpu/ckpt/artifact.py``. The deployable unit is
the complete eval wav -> probs forward (frontend, encoder, head, sigmoid)
lowered once by ``torch.export`` with the weights inside the program. A
``.uitx`` file is a zip archive:

    model.pt2   ``torch.export.save`` of the ExportedProgram
    meta.json   io contract + model config + optional label map

``load_artifact(path)`` gives back a plain ``fn(wav) -> probs``: no model
code of this package runs at call time. The fused mel kernel reaches the
program as the operator ``uit_mobile_tpu_torch::log_mel_rows``
(``ops/mel.py``), which ``load_artifact`` registers before it loads; where
the JAX package serializes its Mosaic kernel into the StableHLO, the port's
program calls that operator, which launches the CUDA kernel on the card and
runs its plain version on the CPU. Artifacts are batch-polymorphic by
default (``Dim("b")``); a kernel artifact needs a fixed batch, because the
row/transposed routing of the kernel depends on the concrete batch.

Input contract: ``(B, n_samples)`` waveforms, float32 normalized to [-1, 1]
or int16 raw PCM (chosen at export; int16 folds the 1/32768 into the DFT,
bitwise the float32 path).

The JAX package's ``uitx-v1`` files hold StableHLO, which PyTorch cannot
run: ``load_artifact`` refuses them and says so.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import zipfile
from pathlib import Path

import torch
from torch import nn

from ..ops.graphs import graphed
from ..utils.device import resolve_device
from .io import config_to_dict

ARTIFACT_FORMAT = "uitx-torch-v1"
JAX_ARTIFACT_FORMAT = "uitx-v1"


class _ServingProgram(nn.Module):
    """What ``torch.export`` traces: the members (one model or an
    ensemble) behind ``make_forward_fn``'s frontend and run config."""

    def __init__(self, members, run_cfg, frontend):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.run_cfg, self.frontend = run_cfg, frontend

    def forward(self, wav):
        from ..ops.pipeline import ensemble_forward

        return ensemble_forward(list(self.members), self.run_cfg, self.frontend, wav)


@dataclasses.dataclass
class ServingExport:
    """An exported serving forward and the contract ``save_artifact``
    records: ``call(wav)`` runs the program on ``device``."""

    program: torch.export.ExportedProgram
    input_shape: list
    input_dtype: str
    output_shape: list
    device: str
    use_kernel: bool

    def call(self, wav):
        with torch.inference_mode():
            return self.program.module()(torch.as_tensor(wav).to(self.device))


def export_serving(cfg, model, *, batch_size=None, n_samples: int = 16000,
                   dtype: str = "float32", precision: str = "exact",
                   use_kernel: bool = False, device="cuda",
                   top_db_mode: str | None = "per_sample") -> ServingExport:
    """Lower the eval wav->probs forward with ``torch.export``.

    ``model``: one model or a list of models of one config (an ensemble
    becomes one program that averages the member probabilities), copied
    onto ``device``. batch_size None -> batch-polymorphic (``Dim("b")``);
    int -> fixed leading dim. dtype 'float32' (normalized wavs) or 'int16'
    (raw PCM). use_kernel=True puts the fused mel kernel in the program
    (``make_forward_fn``'s layout policy at this batch); on a CPU model
    the program then calls the kernel's plain version."""
    from ..ops import mel as mel_ops
    from ..ops.pipeline import _policy

    if use_kernel and batch_size is None:
        raise ValueError(
            "use_kernel=True artifacts need a fixed batch_size: the kernel's "
            "row/transposed routing (TFB_MIN_BATCH) depends on the concrete batch dim")
    if dtype not in ("float32", "int16"):
        raise ValueError(f"dtype must be 'float32' or 'int16', got {dtype!r}")
    dev = resolve_device(device)
    members = model if isinstance(model, (list, tuple)) else [model]
    members = [copy.deepcopy(m).to(dev).eval() for m in members]
    members, _, run_cfg, frontend, use_kernel = _policy(
        cfg, members if len(members) > 1 else members[0], use_kernel, precision,
        top_db_mode, None)
    torch_dtype = torch.int16 if dtype == "int16" else torch.float32
    example = torch.zeros((batch_size or 2, int(n_samples)), dtype=torch_dtype, device=dev)
    if use_kernel:
        # the kernel's constant operands are built before the trace, which
        # finds them built and holds them as lifted constants
        mel_ops._matrices(run_cfg.frontend, dtype == "int16", precision, example.device)
    dynamic = None if batch_size is not None else ({0: torch.export.Dim("b")},)
    with torch.no_grad():
        program = torch.export.export(_ServingProgram(members, run_cfg, frontend).eval(),
                                      (example,), dynamic_shapes=dynamic)
    b = "b" if batch_size is None else str(int(batch_size))
    out_val = next(n for n in program.graph.nodes if n.op == "output").args[0][0]
    return ServingExport(program=program, input_shape=[b, str(int(n_samples))],
                         input_dtype=dtype,
                         output_shape=[b, str(int(out_val.meta["val"].shape[-1]))],
                         device=dev.type, use_kernel=bool(use_kernel))


def save_artifact(path, exported: ServingExport, cfg=None, labels=None,
                  extra: dict | None = None) -> Path:
    """Write an export + metadata as a ``.uitx`` zip (atomically)."""
    path = Path(path)
    meta = {
        "format": ARTIFACT_FORMAT,
        "input_shape": exported.input_shape,
        "input_dtype": exported.input_dtype,
        "output_shape": exported.output_shape,
        "device": exported.device,
        "use_kernel": exported.use_kernel,
        "torch_version": torch.__version__,
        "config": config_to_dict(cfg) if cfg is not None else None,
        "labels": labels,
        "extra": extra or {},
    }
    buf = io.BytesIO()
    torch.export.save(exported.program, buf)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("model.pt2", buf.getvalue())
            z.writestr("meta.json", json.dumps(meta, indent=1))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _constants_on_device(module, device: torch.device) -> int:
    """Fold the program's copies of host constants to a device of
    ``device``'s type (the plain frontend's window and filterbank, lifted
    at export and copied from pageable memory at each call, which a CUDA
    graph cannot do) into device constants made once here: a ``to(device,
    dtype)`` of a host constant, or of its fresh copy, whose result no op
    mutates. -> the copies folded (the module recompiled). The values are
    those the copies gave."""
    aten, graph = torch.ops.aten, module.graph
    folded = 0
    for node in list(graph.nodes):
        if node.op != "call_function" or node.target is not aten.to.device:
            continue
        src = node.args[0]
        if src.op == "call_function" and src.target is aten.lift_fresh_copy.default:
            src = src.args[0]
        value = getattr(module, src.target, None) if src.op == "get_attr" else None
        target = torch.device(node.args[1])
        if (not isinstance(value, torch.Tensor) or value.device.type != "cpu"
                or target.type != device.type
                or any(getattr(u.target, "_schema", None) is None or u.target._schema.is_mutable
                       for u in node.users)):
            continue
        name = f"{src.target}_on_{device.type}"
        module.register_buffer(name, value.to(device=target, dtype=node.args[2]),
                               persistent=False)
        with graph.inserting_before(node):
            node.replace_all_uses_with(graph.get_attr(name))
        graph.erase_node(node)
        folded += 1
    if folded:
        graph.eliminate_dead_code()
        module.recompile()
    return folded


def load_artifact(path, device=None):
    """-> (fn, meta): ``fn(wav) -> probs`` on ``device`` (None: the device
    the artifact was exported on; another device moves the program there).
    On the card the program's module runs as a CUDA graph per batch shape
    (``ops/graphs.py``), as the JAX package's exported program is one jitted
    program: its input checks run on the host at the first, eager call of a
    shape, and the graph holds its device work alone (the host constants
    it copies to the card at each call are folded into device constants
    first). ``fn.program`` is the
    ExportedProgram, ``fn.eager`` the module called without graphs,
    ``fn.graphs`` the ``GraphedFn`` (None on the CPU)."""
    from ..ops import mel  # noqa: F401  (registers uit_mobile_tpu_torch::log_mel_rows)

    with zipfile.ZipFile(Path(path)) as z:
        meta = json.loads(z.read("meta.json").decode())
        if meta.get("format") == JAX_ARTIFACT_FORMAT:
            raise ValueError(
                f"{path} is a JAX package artifact ({JAX_ARTIFACT_FORMAT}, a StableHLO "
                f"program) that PyTorch cannot run; export the checkpoint with "
                f"`python -m uit_mobile_tpu_torch.cli.export CKPT --artifact` instead")
        if meta.get("format") != ARTIFACT_FORMAT:
            raise ValueError(f"not a {ARTIFACT_FORMAT} artifact: {path}")
        program = torch.export.load(io.BytesIO(z.read("model.pt2")))
    dev = resolve_device(device or meta["device"])
    if dev.type != meta["device"]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    module = program.module()
    if dev.type == "cuda":
        _constants_on_device(module, dev)
    run = graphed(module, dev)

    def on_device(call):
        def fn(wav):
            with torch.inference_mode():
                return call(torch.as_tensor(wav).to(dev))

        return fn

    fn = on_device(run)
    fn.program, fn.device = program, dev
    fn.eager, fn.graphs = on_device(module), None if run is module else run
    return fn, meta
