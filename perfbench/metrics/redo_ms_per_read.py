"""Search driver: host ms a read redone, the driver's seconds inside the
host redo (the pool loop's calls of host_search_batch; the one-shot loop's
waits for its deferred redo) over the reads redone, in the window and its
finish (host clock); nothing where no read was redone. It parts the
redo's cost a read from the share of reads sent to it (redo_read_pct)."""


def read(ctx):
    if not ctx.redone:
        return None
    return float(ctx.redo_s) * 1e3 / ctx.redone
