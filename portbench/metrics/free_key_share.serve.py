"""Share of the keys the batcher's decode attention is handed that belong to
free slots, from the program's own counts: the ``free_keys`` over the
``keys`` of the ``batcher.step`` spans that start inside the window, in %. A
free slot's row is thrown away, so its keys are work the step need not do.
Nothing for a program whose steps count no keys, for another entry, nor on a
machine without a card, where the pool's step takes the gather path
(``runtime/paged.py::default_attn_impl``), which reads every table entry
whatever the position, so the keys count no work it skips."""


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
              if s[0] == "batcher.step" and s[5] and "keys" in s[5]]
    keys = sum(c["keys"] for c in counts)
    return 100.0 * sum(c["free_keys"] for c in counts) / keys if keys > 0 else None
