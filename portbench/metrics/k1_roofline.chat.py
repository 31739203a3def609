"""K1's share of its roofline in the traced stretch, in percent: the
least time of every layer's prefill attention over the real prompt rows
(not the padded bucket; ``yardstick.k1_work``, bound by operations) over
K1's device time by kernel name (``flash_gqa_kernel``)."""

from portbench.yardstick import bound_s, k1_work


def read(rec):
    tr = rec.trace
    if rec.entry != "engine" or tr is None or not tr.by_class.get("K1"):
        return None
    d = rec.dims
    ideal = sum(bound_s(*k1_work(s.prompt_len, s.cache_len, 0, d.n_heads, d.n_kv_heads,
                                 d.head_dim))[0] * d.n_layers
                for s in rec.prefilled_in(tr.t0, tr.t1))
    return 100.0 * ideal / tr.by_class["K1"] if ideal else None
