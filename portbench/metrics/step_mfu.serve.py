"""The batched steps' share of the card's bf16 peak, in percent: the model
FLOPs of every prompt admitted and every token delivered inside the window
(real rows: a free slot's padding row and a prefix hit's cached tokens are
not counted) over the total wall of the window's ``step()`` spans."""

from portbench.yardstick import BF16_FLOPS_PER_S


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    w0, w1 = rec.window
    wall = sum(s.t1 - s.t0 for s in rec.spans_in(w0, w1))
    flops = rec.flops_in(w0, w1)
    return 100.0 * flops / (wall * BF16_FLOPS_PER_S) if wall > 0 and flops else None
