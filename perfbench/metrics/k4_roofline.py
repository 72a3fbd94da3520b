"""Kernel K4 (csrc/anchor.cu anchor_pool_kernel): the least time of the
work its launches did over the window and its drain (perfbench/roofline.py:
bytes at the HBM rate or operations at the int32 rate, whichever is
longer), over K4's summed device time in the trace, in %."""

from perfbench import roofline


def read(ctx):
    t, w = ctx.trace, ctx.k4_work
    if t is None or w is None or not t["kernel_launches"].get("K4"):
        return None
    nbytes, ops = roofline.k4_bytes_ops(
        read_symbols=int(ctx.lengths.sum()), reads=ctx.reads,
        launches=ctx.k4_launches, rounds=w["rounds"],
        table_rows=w["table_rows"], text_rows=w["text_rows"],
        compared_symbols=w["symbols"], emissions=ctx.emissions,
        table_bytes=ctx.k4_table_bytes, text_bytes=ctx.k4_text_bytes)
    least, _ = roofline.bound_s(nbytes, ops)
    return 100.0 * least / t["kernel_s"]["K4"]
