"""cuBLAS's share of its roofline in the traced stretch, in percent: the
least time of the stretch's GEMM work over the device time of the GEMM
kernels by name. Admissions: the uncached prompt rows of each prompt
admitted in the stretch. Decode steps: the batcher's ``decode_steps``
across the stretch's ``step()`` spans, each with the stretch's delivered
tokens shared evenly as its rows (bound by the weights' bytes)."""

from portbench.yardstick import gemm_ideal_s


def read(rec):
    tr = rec.trace
    if rec.entry != "paged_batcher" or tr is None or not tr.by_class.get("gemm"):
        return None
    ideal = 0.0
    for s in rec.prefilled_in(tr.t0, tr.t1):
        ideal += gemm_ideal_s(rec.dims, s.prompt_len - rec.cached(s), 1)["total"]
    steps = rec.counter_delta(rec.spans_in(tr.t0, tr.t1), "decode_steps")
    rows = sum(len(s.decode_tokens(tr.t0, tr.t1)) for s in rec.served)
    if steps > 0 and rows > 0:
        ideal += steps * gemm_ideal_s(rec.dims, rows / steps, rows / steps)["total"]
    return 100.0 * ideal / tr.by_class["gemm"] if ideal else None
