"""Host milliseconds a batched decode step spends queuing the forwards and samples of its decode steps (the program's ``batcher.launch`` spans: the host's kernel launches), summed over the
spans that start inside the window, over the decode steps of the window's
``batcher.step`` spans (their ``steps`` count)."""


def read(rec):
    if rec.entry != "paged_batcher":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    spans = SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
    steps = sum(s[5]["steps"] for s in spans if s[0] == "batcher.step" and s[5])
    if steps <= 0:
        return None
    return sum(s[2] - s[1] for s in spans if s[0] == "batcher.launch") / steps / 1e6
