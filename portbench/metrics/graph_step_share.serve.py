"""Share of the batcher's plain decode steps replayed from its captured
step graph, from the program's own counts: the ``graphed`` over the
``steps`` of the ``batcher.step`` spans that start inside the window. Nothing
for a program whose steps count no ``graphed`` (it has no step graph), nor
on a machine without a card, where the step's body runs eagerly."""


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
              if s[0] == "batcher.step" and s[5] and "steps" in s[5]]
    steps = sum(c["steps"] for c in counts)
    if steps <= 0 or any("graphed" not in c for c in counts):
        return None
    return 100.0 * sum(c["graphed"] for c in counts) / steps
