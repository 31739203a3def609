"""Share of the admission prefills' rows that are padding, in percent: the
``padded`` rows over the ``computed`` and ``padded`` rows of the
``batcher.admit`` spans that start inside the window (each prefill runs a
power-of-two bucket rounded up to whole blocks)."""


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    counts = [s[5] for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
              if s[0] == "batcher.admit" and s[5] and "computed" in s[5]]
    rows = sum(c["computed"] + c["padded"] for c in counts)
    return 100.0 * sum(c["padded"] for c in counts) / rows if rows else None
