"""Anchor device tables: seconds of the last `tables: layout` span of the
program (ops/anchor_device.py build_device_anchor: the host arrays laid
out before the upload), the run's one searcher, read with the traced
run's other per-layer metrics; nothing without a device trace, or where
the program has no such span."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from svdss_tpu_torch import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("tables: layout")
    return None if s is None else float(s["last_seconds"])
