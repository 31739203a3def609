"""Model metadata printer.

Capability parity with the reference's PrintMeta (reference:
src/model/loader.go:117-181): full tensor listing with dtypes/shapes, the
hyperparameters from configuration, derived values, and element/byte counts.
"""

from __future__ import annotations

import numpy as np

from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel

_GB = 1024.0 ** 3
_MB = 1024.0 ** 2

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
                "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
                "bool": 1}


def format_meta(model: LoadedModel) -> str:
    cfg = model.cfg
    lines = []
    lines.append("\nTensors:")
    lines.append("=================================")
    elem_count = 0
    byte_count = 0
    for i, (name, (shape, dtype)) in enumerate(model.tensor_meta.items()):
        lines.append(f"Tensor {i:4d}: {name:<48} | {dtype:<8} | {list(shape)}")
        n = int(np.prod(shape)) if shape else 1
        elem_count += n
        byte_count += n * _DTYPE_BYTES.get(dtype, 2)

    lines.append("\nModel Metadata:")
    lines.append("=================================")
    lines.append("Properties from model files:")
    lines.append(f"{'Format':<60} = Torch model")
    lines.append(f"{'Architecture':<60} = Llama")
    lines.append(f"{'Vocabulary type':<60} = BPE (Byte-Pair Encoding)")
    lines.append("\nProperties from model configuration:")
    lines.append(f"{'VocabSize (tokenizer length)':<60} = {cfg.vocab_size}")
    lines.append(f"{'MaxSequenceLength (max context length)':<60} = {cfg.max_sequence_length}")
    lines.append(f"{'Dim (embedding dimension)':<60} = {cfg.dim}")
    lines.append(f"{'N_Heads (attention head count)':<60} = {cfg.n_heads}")
    kv_suffix = " (set to default value of N_Heads)" if cfg.n_kv_heads == -1 else ""
    lines.append(f"{'N_KVHeads (attention head count KV)':<60} = {cfg.n_kv_heads}{kv_suffix}")
    lines.append(f"{'N_Layers (layer count)':<60} = {cfg.n_layers}")
    lines.append(f"{'NormEpsilon (attention layernorm epsilon)':<60} = {cfg.norm_eps:.1e}")
    lines.append(f"{'MultipleOf (for feed forward SwiGLU alignment)':<60} = {cfg.multiple_of}")
    ffn_mult = f"{cfg.ffn_dim_multiplier:.1e}" if cfg.ffn_dim_multiplier > -1 else "None"
    lines.append(f"{'FFNDimMultiplier (custom multiplier for hidden dimension)':<60} = {ffn_mult}")
    lines.append(f"{'RopeTheta (RoPE frequency base)':<60} = {cfg.rope_theta:g}")
    lines.append(f"{'UseScaledRope (Llama-3.1 frequency scaling)':<60} = {cfg.use_scaled_rope}")
    lines.append("\nProperties by calculation:")
    lines.append(f"{'HeadDim (dimension of each attention head)':<60} = {cfg.head_dim}")
    lines.append(f"{'FFNHiddenDim (feed forward network hidden layer dimension)':<60} = {cfg.ffn_hidden_dim}")
    lines.append("\nModel statistics:")
    lines.append(f"{'Model type':<60} = {cfg.model_type}")
    if elem_count:
        lines.append(f"{'Model element count':<60} = {elem_count * 1e-9:.2f} B")
        bits = 8.0 * byte_count / elem_count
        if byte_count < _GB:
            lines.append(f"{'Model bytes count':<60} = {byte_count / _MB:.2f} MB ({bits:.2f} bits per element)")
        else:
            lines.append(f"{'Model bytes count':<60} = {byte_count / _GB:.2f} GB ({bits:.2f} bits per element)")
    return "\n".join(lines) + "\n"
