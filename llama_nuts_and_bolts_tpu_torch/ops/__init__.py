from llama_nuts_and_bolts_tpu_torch.ops.linear import linear, linear_t
from llama_nuts_and_bolts_tpu_torch.ops.rmsnorm import rms_norm
from llama_nuts_and_bolts_tpu_torch.ops.attention import (
    attention_mask,
    attention_mask_per_row,
    gqa_attention,
)
from llama_nuts_and_bolts_tpu_torch.ops.swiglu import swiglu, swiglu_act
from llama_nuts_and_bolts_tpu_torch.ops.sampling import greedy, sample_token
from llama_nuts_and_bolts_tpu_torch.ops.kv_quant import dequantize_kv_rows, quantize_kv_rows
from llama_nuts_and_bolts_tpu_torch.ops.moe import Routing, RoutingLog, expert_ffn, expert_stats
