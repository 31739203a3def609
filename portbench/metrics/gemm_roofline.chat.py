"""cuBLAS's share of its roofline in the traced stretch, in percent: the
least time of the stretch's GEMM work (each forward's weights read once,
real rows only; ``yardstick.gemm_ideal_s``) over the device time of the
GEMM kernels by name. Prefills are bound by operations, decode steps by
bytes."""

from portbench.yardstick import gemm_ideal_s


def read(rec):
    tr = rec.trace
    if rec.entry != "engine" or tr is None or not tr.by_class.get("gemm"):
        return None
    ideal = 0.0
    for s in rec.prefilled_in(tr.t0, tr.t1):
        ideal += gemm_ideal_s(rec.dims, s.prompt_len, 1)["total"]
    n_dec = sum(len(s.decode_tokens(tr.t0, tr.t1)) for s in rec.served)
    ideal += n_dec * gemm_ideal_s(rec.dims, 1, 1)["total"]
    return 100.0 * ideal / tr.by_class["gemm"] if ideal else None
