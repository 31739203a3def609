"""Host milliseconds a decoded token waits for the card: the engine's
``engine.decode.wait`` spans (the host blocked on a replay's tokens) over
the ``steps`` of its ``engine.decode.launch`` spans, both starting inside
the window. ``decode_ms.chat`` less this is the host's own share of a
token."""


def read(rec):
    if rec.entry != "engine":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    w0, w1 = rec.window
    spans = SPANS.between(int(w0 * 1e9), int(w1 * 1e9))
    steps = sum(s[5]["steps"] for s in spans if s[0] == "engine.decode.launch" and s[5])
    if steps <= 0:
        return None
    return sum(s[2] - s[1] for s in spans if s[0] == "engine.decode.wait") / steps / 1e6
