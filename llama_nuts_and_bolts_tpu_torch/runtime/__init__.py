from llama_nuts_and_bolts_tpu_torch.runtime.types import (
    GeneratedPart,
    GenerationState,
    InferenceArgs,
    TokenPiece,
)
from llama_nuts_and_bolts_tpu_torch.runtime.engine import InferenceEngine
