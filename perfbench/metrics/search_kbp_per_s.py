"""Search rate: the bases of every read handed in the window, over the
seconds from the window's first hand-off until the last of those reads
was emitted (host redo and the in-order emit included; host clock). All the
work and all the time: the pool answers a chunk of reads at once, so the
bases finished by a fixed deadline move in steps of a chunk, while the
work of the batches handed, with the drain that finishes it, does not."""

import numpy as np


def read(ctx):
    done = ~np.isnan(ctx.done_at)
    if not done.any():
        return None
    end = float(np.nanmax(ctx.done_at))
    return float(ctx.lengths[done].sum()) / 1e3 / (end - ctx.t0)
