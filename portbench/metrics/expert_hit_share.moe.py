"""Share of the experts the batcher's decode steps read, from the program's
own counts, in percent: the ``experts_hit`` (experts that a live row chose,
summed over the layers) over ``steps`` x layers x experts of the
``batcher.step`` spans that start inside the window. A step reads no expert
that no live row chose, so this is the share of the expert bytes a step
reads. A step's counts land when its tokens are read back, so the last
steps before the batcher stopped may have none, and are left out. Nothing
for a model without experts, for another entry, or for a program whose
steps count no ``experts_hit``."""


def read(rec):
    d = rec.dims
    if rec.entry != "paged_batcher" or not getattr(d, "n_experts", 0):
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    counts = [s[5] for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
              if s[0] == "batcher.step" and s[5] and s[5].get("steps")]
    # a step's counts land when its tokens are read back: the last steps
    # before the batcher stopped may have none
    counts = [c for c in counts if "experts_hit" in c]
    steps = sum(c["steps"] for c in counts)
    if steps <= 0:
        return None
    hit = sum(c["experts_hit"] for c in counts)
    return 100.0 * hit / (steps * d.n_layers * d.n_experts)
