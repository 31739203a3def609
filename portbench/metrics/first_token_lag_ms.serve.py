"""Median milliseconds from the start of a request's admission to its
first token's put on the request's stream: its ``request.first_token``
span (the prefill's launches, the quanta in flight ahead of it, the
read-back), over the admissions that start inside the window."""

from portbench.stats import percentile


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    lags = [(s[2] - s[1]) / 1e6 for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
            if s[0] == "request.first_token"]
    return percentile(lags, 50) if lags else None
