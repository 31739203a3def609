"""Of the card's idle time inside the program's ``batcher.step`` spans of
the traced stretch, the share during which the batcher thread was inside
``batcher.launch`` (queuing kernels), in percent. The rest of the idle
time falls in the step's read-back, delivery, preparation or admissions,
or its own bookkeeping; a captured step would remove the launch share."""

from portbench.stats import gaps, overlap


def read(rec):
    tr = rec.trace
    if rec.entry != "paged_batcher" or tr is None:
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    spans = SPANS.between(int(tr.t0 * 1e9), int(tr.t1 * 1e9))
    idle = []
    for s in spans:
        if s[0] == "batcher.step" and s[2] / 1e9 <= tr.t1:
            idle += gaps(tr.busy, s[1] / 1e9, s[2] / 1e9)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    launch = [(s[1] / 1e9, s[2] / 1e9) for s in spans if s[0] == "batcher.launch"]
    return 100.0 * overlap(idle, launch) / total
