"""The card's idle share inside the batcher's ``step()`` spans of the
traced stretch, in percent: 1 - (the union of device intervals that fall
inside the spans) / the spans' total wall. Below the knee the card also
waits for arrivals between steps; that wait is not the program's."""

from portbench.stats import overlap


def read(rec):
    tr = rec.trace
    if rec.entry != "paged_batcher" or tr is None:
        return None
    spans = [(s.t0, s.t1) for s in rec.spans_in(tr.t0, tr.t1)]
    wall = sum(b - a for a, b in spans)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - overlap(tr.busy, spans) / wall)
