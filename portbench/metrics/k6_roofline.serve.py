"""K6's share of its roofline in the traced stretch, in percent: the
least time of every layer's paged decode attention over K6's device time
by kernel name (``paged_split_kernel``). The work is that of the tokens
delivered in the stretch, step by step (``yardstick.paged_work``, bound by
bytes): each row's visible keys for the operations, and for the bytes each
pool row once, so a shared system prompt's blocks count once a step
however many rows read them. A free slot's steps are not counted."""

from portbench.yardstick import bound_s, paged_work


def read(rec):
    tr = rec.trace
    if rec.entry != "paged_batcher" or tr is None or not tr.by_class.get("K6"):
        return None
    d = rec.dims
    ideal = 0.0
    for step in rec.steps_in(tr.t0, tr.t1):
        positions = [s.prompt_len + i - 1 for s, i in step]
        shared = {s.system: s.shared_len for s, _ in step if s.system is not None}
        distinct = sum(shared.values()) + sum(p + 1 - s.shared_len
                                              for (s, _), p in zip(step, positions))
        w = paged_work(positions, d.n_heads, d.n_kv_heads, d.head_dim,
                       distinct_rows=distinct)
        ideal += bound_s(*w)[0] * d.n_layers
    return 100.0 * ideal / tr.by_class["K6"] if ideal else None
