"""Search driver: of the reads the host engine searched in the process
(set-up's warm calls included), the % whose exact list passed the native
engine's first emission cap, so that it searched them twice (the
program's counters `redo: rerun` and `redo: reads`), read with the
traced run's other per-layer metrics; nothing without a device trace,
where the program has no such counters, or where it redid no read."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from svdss_tpu_torch import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    reads = c.get("redo: reads", 0)
    if not reads:
        return None
    return 100.0 * c.get("redo: rerun", 0) / reads
