"""Seconds the engine spent warming up and capturing decode graphs, one a
cache bucket: its ``engine.graph_capture`` spans from the process's start
to the window's end (set-up, and any rebuild inside the window). Nothing
where no graph was captured (the CPU replays none)."""


def read(rec):
    if rec.entry != "engine":
        return None
    try:
        from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    spans = [s for s in SPANS.between(0, int(rec.window[1] * 1e9))
             if s[0] == "engine.graph_capture"]
    return sum(s[2] - s[1] for s in spans) / 1e9 if spans else None
