from llama_nuts_and_bolts_tpu_torch.ops.linear import linear, linear_t
from llama_nuts_and_bolts_tpu_torch.ops.rmsnorm import rms_norm
from llama_nuts_and_bolts_tpu_torch.ops.attention import (
    attention_mask,
    attention_mask_per_row,
    gqa_attention,
)
from llama_nuts_and_bolts_tpu_torch.ops.swiglu import swiglu
from llama_nuts_and_bolts_tpu_torch.ops.sampling import greedy, sample_token
