"""Live rows a batched decode step, from the program's own counts: the
``rows`` over the ``steps`` of the ``batcher.step`` spans that start inside
the window. At a fixed arrival rate the rows are the rate times the time a
request stays, so a faster step lowers them."""


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    counts = [s[5] for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
              if s[0] == "batcher.step" and s[5]]
    steps = sum(c["steps"] for c in counts)
    return sum(c["rows"] for c in counts) / steps if steps > 0 else None
