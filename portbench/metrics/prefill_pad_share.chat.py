"""Share of the engine's prefill rows that are padding, in percent: the
``padded`` rows over the rows run (``prompt`` less ``reused`` plus
``padded``) of the ``engine.prefill`` spans that start inside the window
(each prefill runs a power-of-two bucket)."""


def read(rec):
    if rec.entry != "engine":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    counts = [s[5] for s in SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
              if s[0] == "engine.prefill" and s[5]]
    rows = sum(c["prompt"] - c["reused"] + c["padded"] for c in counts)
    return 100.0 * sum(c["padded"] for c in counts) / rows if rows else None
