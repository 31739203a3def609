"""Host milliseconds a decoded token of the sequential engine: each
request's time from its first token to its last inside the window (every
token is read back, so each stamp follows a synchronisation), over its
tokens after the first."""


def read(rec):
    if rec.entry != "engine":
        return None
    w0, w1 = rec.window
    total = n = 0
    for s in rec.served:
        ts = [t for t in s.times if w0 <= t <= w1]
        if len(ts) >= 2:
            total += ts[-1] - ts[0]
            n += len(ts) - 1
    return total / n * 1e3 if n else None
