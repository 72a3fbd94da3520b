"""Anchor pool: host ms inside the benchmark's spans around the pool's
calls (feed, pump, drain, creation) per 1,000 reads, over the window and
its drain; nothing where the run took no pool."""


def read(ctx):
    if ctx.reads == 0 or ctx.pool_s is None:
        return None
    return float(ctx.pool_s) * 1e3 / (ctx.reads / 1e3)
