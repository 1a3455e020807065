"""The parallel layer (port of diffse_tpu/parallel): the process group and
the data mesh, the ``(data, model)`` mesh of tensor parallelism, the
frames-parallel ``sequence`` mesh of one utterance's enhancement, and
``dryrun``, which spawns ranks and runs a data- and a tensor-parallel
step."""

from .mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    microbatch_sharding,
    replicate,
    replicated_sharding,
    shard_batch,
    stacked_batch_sharding,
)
from .model_sharding import (
    leaf_partition_spec,
    make_2d_mesh,
    shard_state,
    shard_tree,
    shard_variables,
    state_shardings,
    tree_shardings,
    variables_shardings,
)
from .sequence import constrain_frames, current_frames, make_seq_mesh, spec_seq_sharding

__all__ = [
    "make_mesh",
    "batch_sharding",
    "microbatch_sharding",
    "stacked_batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "initialize_distributed",
    "make_2d_mesh",
    "leaf_partition_spec",
    "tree_shardings",
    "shard_tree",
    "shard_state",
    "shard_variables",
    "state_shardings",
    "variables_shardings",
    "make_seq_mesh",
    "spec_seq_sharding",
    "constrain_frames",
    "current_frames",
]
