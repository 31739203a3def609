"""Host milliseconds a batched decode step: the benchmark's spans around
``PagedBatcher.step()`` inside the window, over the batcher's own
``decode_steps`` counter across them (admission prefills included)."""


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    spans = rec.spans_in(*rec.window)
    steps = rec.counter_delta(spans, "decode_steps")
    if steps <= 0:
        return None
    return sum(s.t1 - s.t0 for s in spans) / steps * 1e3
