"""Search driver, one-shot loop: ms per 1,000 reads handed in the window
inside the program's own `search: dispatch` and `search: collect` spans
(pipeline/search.py _DeviceSearcher: a batch packed and launched; its
results fetched and made into per-read lists), on the profiler's clock
over the traced window; nothing without a trace, without those spans or
without reads."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.reads == 0:
        return None
    spans = [t["host_spans"].get(n)
             for n in ("search: dispatch", "search: collect")]
    if all(s is None for s in spans):
        return None
    return sum(s or 0.0 for s in spans) * 1e3 / (ctx.reads / 1e3)
