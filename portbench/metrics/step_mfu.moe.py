"""The batcher's steps' share of the card's bf16 peak, in percent: the model
FLOPs of the live rows of the window's ``batcher.step`` spans (each row
through the attention projections, its visible keys, the router and the
head, and its two experts: the step's ``expert_rows``) and of the
admissions' computed prompt rows (``batcher.admit``: the rows, the keys each
sees, the routed pairs, one head row), over the wall of the benchmark's
spans around ``step()`` in the window (host clock). Padding and free slots
are not counted. A step's counts land when its tokens are read
back: the window ends where the first step without them began (one of
the last before the batcher stopped). Nothing for a model without experts, for another entry,
without the program's counts, or on a machine without a card."""

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
    # a step's counts land when its tokens are read back: the window ends
    # where the first step without them (one of the last before the batcher
    # stopped) began
    w1 = min([s[1] / 1e9 for s in spans if s[0] == "batcher.step" and s[5]
              and s[5].get("steps") and "experts_hit" not in s[5]] + [w1])
    spans = [s for s in spans if s[1] / 1e9 < w1]
    steps = [s[5] for s in spans if s[0] == "batcher.step" and s[5] and s[5].get("steps")]
    admits = [s[5] for s in spans if s[0] == "batcher.admit" and s[5] and "computed" in s[5]]
    if not steps or any("expert_rows" not in c for c in steps + admits):
        return None
    flops = sum(d.flops(c["rows"], c["keys"] - c["free_keys"], c["expert_rows"], c["rows"])
                for c in steps)
    flops += sum(d.flops(c["computed"], attention_keys(c["cached"], c["computed"]),
                         c["expert_rows"], 1) for c in admits)
    wall = sum(s.t1 - s.t0 for s in rec.spans_in(w0, w1))
    return 100.0 * flops / (wall * BF16_FLOPS_PER_S) if wall > 0 and flops else None
