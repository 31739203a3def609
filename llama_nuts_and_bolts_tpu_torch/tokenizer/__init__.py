from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import TiktokenModel, load_tiktoken_model
from llama_nuts_and_bolts_tpu_torch.tokenizer.vocab import Vocabulary
from llama_nuts_and_bolts_tpu_torch.tokenizer.bpe import byte_pair_merge, encode_ordinary
from llama_nuts_and_bolts_tpu_torch.tokenizer.chat import (
    PromptPart,
    render_chat_tokens,
    render_prefix_tokens,
)
