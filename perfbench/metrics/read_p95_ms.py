"""Per-read latency, 95th percentile: from the hand-off of a read's batch
to its emit (its merged SFS list made, in stream order, as run_search
emits it), over every read handed in the window (each waited for, after
the close too), in ms (host clock)."""

import numpy as np


def read(ctx):
    lat = (ctx.done_at - ctx.hand_at) * 1e3
    lat = lat[~np.isnan(lat)]
    if len(lat) == 0:
        return None
    return float(np.percentile(lat, 95))
