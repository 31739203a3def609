"""The batcher's steps against their least time, in percent: the least time
of the work inside the window's ``step()`` calls over the wall of the
benchmark's spans around them (host clock). A decode step's least time is
its bytes at 3.35 TB/s: the weights every step reads once (attention, norms,
routers, head), each expert a live row chose read once (``experts_hit`` of
its ``batcher.step`` span), and the live rows' visible keys and values
(``keys`` less ``free_keys``). An admission's prefill inside a step counts
the larger of its bytes (the same weights, the experts it hit) and its
model FLOPs at the bf16 peak (``batcher.admit``'s rows and routed pairs).
A step that reads every expert, or that a free slot's rows make route,
reads below 100 however fast its kernels are. A step's counts land when its tokens are read
back: the window ends where the first step without them began (one of
the last before the batcher stopped). Nothing for a model without
experts, for another entry, without the program's counts, or on a machine
without a card: the share is of the card's peaks."""

from portbench.yardstick import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, BF16, attention_keys


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
    if not steps or any("experts_hit" not in c for c in steps + admits):
        return None
    expert_bytes = BF16 * d.expert_params
    least = 0.0
    for c in steps:
        nbytes = (c["steps"] * d.dense_bytes + c["experts_hit"] * expert_bytes
                  + d.kv_bytes(c["keys"] - c["free_keys"]))
        least += nbytes / HBM_BYTES_PER_S
    for c in admits:
        nbytes = d.dense_bytes + c["experts_hit"] * expert_bytes
        flops = d.flops(c["computed"], attention_keys(c["cached"], c["computed"]),
                        c["expert_rows"], 1)
        least += max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
    wall = sum(s.t1 - s.t0 for s in rec.spans_in(w0, w1))
    return 100.0 * least / wall if wall > 0 else None
