"""Meshes, partition specs and collectives of the port (counterpart of
``torchsnapshot_tpu/parallel``; ``pipeline.py`` is not ported yet)."""

from .mesh import P, PartitionSpec, make_mesh, shard_map, shard_pytree  # noqa: F401
