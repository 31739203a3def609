"""CLI of the PyTorch port: the weights-free --tiny path runs end to end on
the CPU when asked, and refuses a missing card instead of falling back."""

import pytest
import torch

from llama_nuts_and_bolts_tpu_torch.cli.main import main, parse_args


def test_tiny_cpu_prompt_runs_to_the_finish_line(capsys):
    assert main(["--tiny", "--device", "cpu", "--prompt-text", "hello",
                 "--seq-len", "40"]) == 0
    out = capsys.readouterr().out
    assert "Tiny random-weights demo model loaded." in out
    assert "Finished \x1b[1mby reaching" in out


def test_tiny_cpu_chat_with_chunked_prefill_and_plain_attention(capsys):
    assert main(["--tiny", "--device", "cpu", "--chat", "--system-prompt", "Be brief",
                 "--prompt-text", "hi", "--seq-len", "96", "--prefill-chunk", "16",
                 "--attn-impl", "plain"]) == 0
    assert "Finished \x1b[1mby reaching" in capsys.readouterr().out


def test_tiny_cpu_int4_weights_int8_cache_runs_to_the_finish_line(capsys):
    assert main(["--tiny", "--device", "cpu", "--quant", "int4", "--kv-cache", "int8",
                 "--seq-len", "256", "--prompt-text", "hi"]) == 0
    out = capsys.readouterr().out
    assert "Tiny demo model loaded (int4-quantized)." in out
    assert "Finished \x1b[1mby " in out


def test_tiny_cpu_decode_chunk_keeps_the_transcript(capsys):
    """--decode-chunk 4 streams in 4-step chunks (the CPU runs each decode
    graph's body eagerly): the same Assistant line and finish as per-token."""
    def assistant(chunk):
        assert main(["--tiny", "--device", "cpu", "--prompt-text", "hello",
                     "--seq-len", "48", "--decode-chunk", chunk]) == 0
        out = capsys.readouterr().out
        assert "Finished \x1b[1mby reaching sequence length" in out
        return [line for line in out.splitlines() if "Assistant" in line][-1]

    assert assistant("4") == assistant("1")
    assert parse_args(["--decode-chunk", "8"]).decode_chunk == 8


def test_tiny_cpu_probe_keeps_the_transcript(capsys):
    """--attn-impl probe probes each cache bucket once (on the CPU one
    candidate, the plain path): the Assistant line of auto."""
    def assistant(impl):
        assert main(["--tiny", "--device", "cpu", "--attn-impl", impl,
                     "--prompt-text", "hello", "--seq-len", "48"]) == 0
        out = capsys.readouterr().out
        assert "Finished \x1b[1mby reaching" in out
        return [line for line in out.splitlines() if "Assistant" in line][-1]

    assert assistant("probe") == assistant("auto")
    assert parse_args(["--attn-impl", "probe"]).attn_impl == "probe"


def test_meta_and_defaults(capsys):
    assert main(["--tiny", "--device", "cpu", "--meta"]) == 0
    assert "N_Heads (attention head count)" in capsys.readouterr().out
    args = parse_args([])
    assert (args.device, args.attn_impl, args.seq_len) == ("cuda", "auto", 200)
    assert (args.quant, args.kv_cache, args.decode_chunk) == ("none", "bf16", 0)
    assert args.narrate is False
    with pytest.raises(SystemExit):
        parse_args(["--attn-impl", "xla"])


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--tiny", "--prompt-text", "hello"])
