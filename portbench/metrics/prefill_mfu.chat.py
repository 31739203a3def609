"""The prefill's share of the card's bf16 peak, in percent: the model
FLOPs of the window's prompts (real rows only) over the time from each
request's start to its first token."""

from portbench.yardstick import BF16_FLOPS_PER_S


def read(rec):
    if rec.entry != "engine":
        return None
    reqs = rec.prefilled_in(*rec.window)
    wall = sum(s.first - s.start for s in reqs)
    if not reqs or wall <= 0:
        return None
    return 100.0 * sum(rec.prefill_flops(s) for s in reqs) / (wall * BF16_FLOPS_PER_S)
