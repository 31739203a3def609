"""Share of the seated admissions whose prefill attended on K1, in percent,
from the program's own counts: the ``flash`` over the number of the seated
``batcher.admit`` spans that start inside the window. Nothing for a program
whose admissions count no ``flash``, nor on a machine without a card, where
K1's plain version stands in for the kernel."""


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    try:
        import torch

        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    if not torch.cuda.is_available():
        return None
    w0, w1 = rec.window
    counts = [s[5] for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
              if s[0] == "batcher.admit" and s[5] and "computed" in s[5]]
    if not counts or any("flash" not in c for c in counts):
        return None
    return 100.0 * sum(c["flash"] for c in counts) / len(counts)
