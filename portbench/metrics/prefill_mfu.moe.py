"""The admission prefills' share of the card's bf16 peak, in percent:
``prefill_mfu.serve``'s definition with the expert layer's counts. The model
FLOPs of the seated ``batcher.admit`` spans that start inside the window
(the rows each computed, seeing the cached rows before them and themselves
causally, their routed (row, expert) pairs ``expert_rows``, one head row)
over the same requests' ``request.first_token`` walls, from the admission's
start to the first token's put. Nothing for a model without experts, for
another entry, without the program's counts, or on a machine without a
card: the share is of the card's peak."""

from portbench.yardstick import BF16_FLOPS_PER_S, attention_keys


def read(rec):
    d = rec.dims
    if rec.entry != "paged_batcher" or not getattr(d, "n_experts", 0):
        return None
    try:
        import torch

        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    if not torch.cuda.is_available():
        return None
    w0, w1 = rec.window
    spans = SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
    walls = {s[3]: s[2] - s[1] for s in spans if s[0] == "request.first_token"}
    seated = [s for s in spans if s[0] == "batcher.admit" and s[5] and "computed" in s[5]
              and s[3] in walls]
    if not seated or any("expert_rows" not in s[5] for s in seated):
        return None
    wall_s = sum(walls[s[3]] for s in seated) / 1e9
    flops = sum(d.flops(s[5]["computed"], attention_keys(s[5]["cached"], s[5]["computed"]),
                        s[5]["expert_rows"], 1) for s in seated)
    return 100.0 * flops / (wall_s * BF16_FLOPS_PER_S) if wall_s > 0 else None
