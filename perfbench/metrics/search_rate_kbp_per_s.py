"""Search rate as a per-layer reading, for cells where the end-to-end
``search_kbp_per_s`` spreads wider between runs than its bound allows:
the same number (the bases of every read handed in the window, over the
seconds from the window's first hand-off until the last of those reads
was emitted; host clock), kept without a bound."""

import numpy as np


def read(ctx):
    done = ~np.isnan(ctx.done_at)
    if not done.any():
        return None
    end = float(np.nanmax(ctx.done_at))
    return float(ctx.lengths[done].sum()) / 1e3 / (end - ctx.t0)
