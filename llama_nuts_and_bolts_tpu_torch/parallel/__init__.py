"""Tensor parallelism over ``torch.distributed``: the mesh, the Megatron
splits of the weights, the dense cache and the paged pool, the attention
kernels on a rank's head shard, and the one-process-a-rank launch."""

from llama_nuts_and_bolts_tpu_torch.parallel.mesh import (
    initialize_multihost,
    make_mesh,
    tp_rank,
    tp_size,
)
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import (
    param_sharding_fn,
    pool_sharding,
    shard_cache,
    shard_params,
    shard_pool,
)

__all__ = ["initialize_multihost", "make_mesh", "param_sharding_fn", "pool_sharding",
           "shard_cache", "shard_params", "shard_pool", "tp_rank", "tp_size"]
