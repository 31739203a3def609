"""Tensor parallelism over ``torch.distributed``: the mesh, the Megatron
splits, and the attention kernels on a rank's head shard."""

from llama_nuts_and_bolts_tpu_torch.parallel.mesh import (
    initialize_multihost,
    make_mesh,
    tp_rank,
    tp_size,
)
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import (
    param_sharding_fn,
    shard_cache,
    shard_params,
)

__all__ = ["initialize_multihost", "make_mesh", "param_sharding_fn", "shard_cache",
           "shard_params", "tp_rank", "tp_size"]
