"""Anchor pool: ms per 1,000 reads handed in the window inside the
program's own `pool: fetch` spans (ops/anchor_pool.py: the chunk's four
result arrays copied to the host), on the profiler's clock over the traced
window; nothing without a trace, without that span or without reads."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.reads == 0:
        return None
    s = t["host_spans"].get("pool: fetch")
    if s is None:
        return None
    return float(s) * 1e3 / (ctx.reads / 1e3)
