"""K2's share of its roofline in the traced stretch, in percent: the
least time of every layer's decode attention over the keys visible at each
decoded position (``yardstick.k2_work``, bound by bytes) over K2's device
time by kernel name (``flash_decode_kernel``)."""

from portbench.yardstick import bound_s, k2_work


def read(rec):
    tr = rec.trace
    if rec.entry != "engine" or tr is None or not tr.by_class.get("K2"):
        return None
    d = rec.dims
    ideal = 0.0
    for s in rec.served:
        for i in s.decode_tokens(tr.t0, tr.t1):
            w = k2_work([s.prompt_len + i - 1], s.cache_len, d.n_heads, d.n_kv_heads,
                        d.head_dim)
            ideal += bound_s(*w)[0] * d.n_layers
    return 100.0 * ideal / tr.by_class["K2"] if ideal else None
