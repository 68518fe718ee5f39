"""Meshes, partition specs, collectives and pipelines of the port
(counterpart of ``torchsnapshot_tpu/parallel``)."""

from .mesh import P, PartitionSpec, make_mesh, shard_map, shard_pytree  # noqa: F401
from .pipeline import (  # noqa: F401
    pipeline_1f1b_spmd,
    pipeline_param_sharding,
    pipeline_spmd,
    pipelined_apply,
    pipelined_value_and_grad,
)
