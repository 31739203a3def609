"""Median milliseconds a request waited in the batcher's queue: its
``request.queued`` span (stamped by the program: submit to the start of the
admission that seats it) over the requests submitted inside the window."""

from portbench.stats import percentile


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    waits = [(s[2] - s[1]) / 1e6 for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
             if s[0] == "request.queued"]
    return percentile(waits, 50) if waits else None
