"""Parallelism, counterpart of ``uit_mobile_tpu/parallel``: data
parallelism over processes (``multihost``, one rank a card) and over an
in-process mesh (``mesh``), the global-batch semantics of the train step
(``rows``), FSDP and hybrid FSDP x TP (``fsdp``), and model parallelism
over a process group's ``GridMesh``: Megatron tensor parallelism (``tp``),
ring-attention sequence parallelism (``sp``), the GPipe pipeline (``pp``)
and expert-parallel MoE banks with the MoE train step (``ep``)."""

from . import multihost
from .ep import ep_param_specs, ep_shard_params, expert_parallel_forward, make_expert_mesh
from .ep import make_moe_train_step
from .fsdp import (fsdp_forward, fsdp_param_specs, fsdp_shard_params, hybrid_param_specs,
                   hybrid_shard_params)
from .mesh import (GridMesh, Mesh, batch_sharded, data_parallel_forward, dp_placement,
                   make_grid_mesh, make_mesh, process_mesh, replicate_tree, replicated,
                   shard_batch)
from .pp import make_pipe_mesh, pipeline_forward, stack_block_params
from .rows import Rows, ThreadGroup, current, sharded
from .sp import make_seq_mesh, sequence_parallel_forward
from .tp import (make_mesh_2d, shard_params, sharded_opt_init, tensor_parallel_forward,
                 tp_param_specs)

__all__ = [
    "GridMesh",
    "Mesh",
    "Rows",
    "ThreadGroup",
    "batch_sharded",
    "current",
    "data_parallel_forward",
    "dp_placement",
    "ep_param_specs",
    "ep_shard_params",
    "expert_parallel_forward",
    "fsdp_forward",
    "fsdp_param_specs",
    "fsdp_shard_params",
    "hybrid_param_specs",
    "hybrid_shard_params",
    "make_expert_mesh",
    "make_grid_mesh",
    "make_mesh",
    "make_mesh_2d",
    "make_moe_train_step",
    "make_pipe_mesh",
    "make_seq_mesh",
    "multihost",
    "pipeline_forward",
    "process_mesh",
    "replicate_tree",
    "replicated",
    "sequence_parallel_forward",
    "shard_batch",
    "shard_params",
    "sharded",
    "sharded_opt_init",
    "stack_block_params",
    "tensor_parallel_forward",
    "tp_param_specs",
]
