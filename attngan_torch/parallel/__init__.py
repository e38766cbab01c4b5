"""Data parallelism over the ranks of a torchrun launch. JAX's mesh and
sharding helpers (``DATA_AXIS``, ``SLICE_AXIS``, ``batch_axes``,
``batch_sharding``, ``make_mesh_for_batch``, ``replicate``, ``replicated``,
``shard_batch``) place arrays on a jax.sharding.Mesh; here each rank holds
its own rows: ``mesh_size_for_batch`` / ``make_mesh`` size the ranks' mesh,
``shard_rows`` takes a rank's rows, and ``init_distributed`` / ``launched``
start the process group."""

from attngan_torch.parallel.mesh import (
    init_distributed,
    launched,
    make_mesh,
    mesh_size_for_batch,
    shard_rows,
)

__all__ = [
    "init_distributed",
    "launched",
    "make_mesh",
    "mesh_size_for_batch",
    "shard_rows",
]
