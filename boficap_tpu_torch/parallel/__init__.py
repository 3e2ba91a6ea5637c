"""Data and tensor parallelism over ``torch.distributed`` ranks: the port
of the JAX package's ``parallel/``."""

from .mesh import (Mesh, batch_sharding, gather_params, gather_rows,
                   init_group, make_mesh, pad_batch_to,
                   param_partition_specs, replicate_state, shard_batch,
                   shard_params)

__all__ = ["Mesh", "batch_sharding", "gather_params", "gather_rows",
           "init_group", "make_mesh", "pad_batch_to",
           "param_partition_specs", "replicate_state", "shard_batch",
           "shard_params"]
