from llama_nuts_and_bolts_tpu_torch.quant.quantize import (
    QTensor,
    dequantize,
    init_random_params_q8,
    quantize_params,
    quantize_tensor,
)
from llama_nuts_and_bolts_tpu_torch.quant.int4 import (
    Q4Tensor,
    fit_group,
    host_quantize_q4,
    init_random_params_q4,
    quantize_params_q4,
    quantize_tensor_q4,
    unpack_q4,
)
