"""The ``(dp, sp, tp)`` mesh over ``torch.distributed``: the mesh and its
collectives, the Megatron splits of the weights, the dense cache's rows and
heads, the paged pool's heads and the tokens' blocks, the attention kernels
on a rank's rows and heads, ring attention on the sp axis, and the
one-process-a-rank launch."""

from llama_nuts_and_bolts_tpu_torch.parallel.mesh import (
    dp_rank,
    dp_size,
    initialize_multihost,
    make_mesh,
    sp_rank,
    sp_size,
    tp_rank,
    tp_size,
)
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import (
    cache_sharding,
    param_sharding_fn,
    pool_sharding,
    shard_cache,
    shard_params,
    shard_pool,
    shard_tokens,
    token_sharding,
)

__all__ = ["cache_sharding", "dp_rank", "dp_size", "initialize_multihost", "make_mesh",
           "param_sharding_fn", "pool_sharding", "shard_cache", "shard_params", "shard_pool",
           "shard_tokens", "sp_rank", "sp_size", "token_sharding", "tp_rank", "tp_size"]
