"""Search driver: reads the pool flagged and the host engine redid, in %
of the reads handed in the window (the searcher's fallback count)."""


def read(ctx):
    if ctx.reads == 0:
        return None
    return 100.0 * ctx.redone / ctx.reads
