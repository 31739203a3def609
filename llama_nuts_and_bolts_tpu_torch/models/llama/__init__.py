from llama_nuts_and_bolts_tpu_torch.models.llama.rope import precompute_rope_tables, apply_rope
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    KVCache,
    LlamaParams,
    forward,
    fuse_decode_params,
    init_random_params,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
    build_params_from_checkpoint,
    load_llama_model,
    LoadedModel,
)
