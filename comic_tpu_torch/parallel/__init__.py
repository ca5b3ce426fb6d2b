"""Data parallelism on torch.distributed; counterpart of comic_tpu/parallel
(mesh.py: the mesh and its batch helpers; distributed.py: joining a
multi-process job)."""

from .distributed import maybe_initialize_distributed
from .mesh import (
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS", "batch_sharding", "make_mesh",
    "maybe_initialize_distributed", "replicate", "replicated",
    "shard_batch",
]
