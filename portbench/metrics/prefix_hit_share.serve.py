"""Share of the prefix cache's block lookups that hit, in percent, from the
allocator's own counters (the server's ``llama_prefix_cache_hits_total``
and ``_lookups_total``) across the window's steps."""


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    spans = rec.spans_in(*rec.window)
    lookups = rec.counter_delta(spans, "prefix_lookups")
    if lookups <= 0:
        return None
    return 100.0 * rec.counter_delta(spans, "prefix_hits") / lookups
