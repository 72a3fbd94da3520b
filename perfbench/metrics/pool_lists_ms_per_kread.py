"""Anchor pool: ms per 1,000 reads handed in the window inside the
program's own `pool: lists` spans (ops/anchor_pool.py: each read's
(qs, length) list built from the fetched arrays), on the profiler's clock
over the traced window; nothing without a trace, without that span or
without reads."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.reads == 0:
        return None
    s = t["host_spans"].get("pool: lists")
    if s is None:
        return None
    return float(s) * 1e3 / (ctx.reads / 1e3)
