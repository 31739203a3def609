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


def test_meta_and_defaults(capsys):
    assert main(["--tiny", "--device", "cpu", "--meta"]) == 0
    assert "N_Heads (attention head count)" in capsys.readouterr().out
    args = parse_args([])
    assert (args.device, args.attn_impl, args.seq_len) == ("cuda", "auto", 200)
    with pytest.raises(SystemExit):
        parse_args(["--attn-impl", "xla"])


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--tiny", "--prompt-text", "hello"])
