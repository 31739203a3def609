"""The card's idle share of the traced stretch, in percent: 1 - (the union
of every device interval, kernels and copies, on the trace's timeline) /
the stretch's wall."""

from portbench.stats import covered


def read(rec):
    tr = rec.trace
    if rec.entry != "engine" or tr is None or tr.seconds <= 0:
        return None
    return 100.0 * (1.0 - covered(tr.busy) / tr.seconds)
