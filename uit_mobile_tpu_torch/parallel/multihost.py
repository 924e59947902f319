"""Multi-process initialization, counterpart of
``uit_mobile_tpu/parallel/multihost.py``.

Every rank runs the same command; ``initialize`` joins them into one
``torch.distributed`` process group (NCCL for CUDA devices, gloo for the
CPU or when the caller asks for it). A rank that never arrives makes the
others raise after ``timeout`` seconds instead of hanging. Data loading
stays per rank: ``host_local_batch_slice`` says which rows of the global
batch a rank loads, and each rank keeps them (``global_batch_from_host_local``):
the step's collectives (``parallel/rows.py``) make it the global batch's.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

# seconds a rank waits for the others at the rendezvous and at a collective
DEFAULT_TIMEOUT_S = 300.0


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of ranks (1 outside a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               strict: bool = False, device="cuda", backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``tcp://coordinator_address`` with the given
    world size and rank, or ``env://`` (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, as a launcher such as torchrun sets them) without a
    coordinator. ``backend``: None = NCCL for a CUDA ``device`` (which
    becomes the process's current card), gloo for the CPU.

    ``strict=True`` (an explicit ``multihost:`` request): a failed init
    raises. Without it, a single process with no coordinator and no
    launcher environment stays un-distributed; but an explicit request
    that degraded silently would have every rank train the full batch
    independently as rank 0."""
    import torch.distributed as dist

    if is_initialized():
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    elif not strict and num_processes in (None, 1):
        return  # best effort: one process, nothing to join
    else:
        raise RuntimeError(
            "multihost was explicitly requested but there is no coordinator_address and "
            "no MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK environment — refusing to degrade "
            "to an un-distributed run (every rank would train the full batch independently "
            "as rank 0)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if num_processes is not None:
        kwargs.update(world_size=int(num_processes), rank=int(process_id or 0))
    try:
        dist.init_process_group(backend, init_method=init_method,
                                timeout=datetime.timedelta(seconds=timeout), **kwargs)
    except (RuntimeError, ValueError) as e:
        if strict:
            raise RuntimeError(
                "multihost was explicitly requested but init_process_group failed — "
                "refusing to degrade to an un-distributed run (every rank would train "
                "the full batch independently as rank 0)") from e
        raise


def initialize_from_config(multihost_cfg, device="cuda", backend: Optional[str] = None) -> None:
    """Config-key entry point: ``multihost: true`` (the launcher's
    environment, ``env://``) or a dict with ``coordinator_address`` /
    ``num_processes`` / ``process_id``. Runs before the trainer builds
    anything."""
    if not multihost_cfg:
        return
    kwargs = multihost_cfg if isinstance(multihost_cfg, dict) else {}
    allowed = {"coordinator_address", "num_processes", "process_id"}
    unknown = set(kwargs) - allowed
    if unknown:
        raise ValueError(f"unknown multihost config keys {sorted(unknown)}; "
                         f"allowed: {sorted(allowed)}")
    initialize(strict=True, device=device, backend=backend, **kwargs)


def host_local_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch this rank loads."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"the global batch ({global_batch}) must divide by the process "
                         f"count ({n})")
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def global_batch_from_host_local(mesh, host_batch):
    """Each rank's rows of the global batch, on the rank's device: the rank
    keeps them (the step's collectives make it the global batch's step)."""
    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return torch.as_tensor(x).to(mesh.devices[0])

    return put(host_batch)
