"""Parallelism, counterpart of ``uit_mobile_tpu/parallel``: data
parallelism over processes (``multihost``, one rank a card) and over an
in-process mesh (``mesh``), the global-batch semantics of the train step
(``rows``), FSDP (``fsdp``) and the single-device MoE train step (``ep``).
Tensor, sequence, pipeline and expert parallelism are ROADMAP §A17b."""

from . import multihost
from .ep import make_moe_train_step
from .mesh import (Mesh, batch_sharded, data_parallel_forward, dp_placement, make_mesh,
                   process_mesh, replicate_tree, replicated, shard_batch)
from .rows import Rows, ThreadGroup, current, sharded

__all__ = [
    "Mesh",
    "Rows",
    "ThreadGroup",
    "batch_sharded",
    "current",
    "data_parallel_forward",
    "dp_placement",
    "make_mesh",
    "make_moe_train_step",
    "multihost",
    "process_mesh",
    "replicate_tree",
    "replicated",
    "shard_batch",
    "sharded",
]
