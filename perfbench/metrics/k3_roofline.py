"""Kernel K3 (csrc/anchor.cu anchor_batch_kernel, the one-shot narrow
anchor engine): the least time of the work its launches did over the
window and its finish (perfbench/roofline.py k3_bytes_ops: bytes at the HBM
rate or operations at the int32 rate, whichever is longer), over K3's
summed device time in the trace, in %. Its lanes are the reads handed and
the one-symbol reads that pad each batch to its lane count; the emissions
are those of the lanes K3 did not flag."""

from perfbench import roofline


def read(ctx):
    t, w = ctx.trace, ctx.k3_work
    if t is None or w is None or not t["kernel_launches"].get("K3"):
        return None
    pad = ctx.k3_lanes - ctx.reads
    nbytes, ops = roofline.k3_bytes_ops(
        lane_symbols=int(ctx.lengths.sum()) + ctx.reads + 2 * pad,
        lanes=ctx.k3_lanes, launches=ctx.k3_launches, rounds=w["rounds"],
        table_rows=w["table_rows"], text_rows=w["text_rows"],
        compared_symbols=w["symbols"], emissions=ctx.emissions,
        table_bytes=ctx.tables_bytes.get("small"),
        text_bytes=ctx.tables_bytes.get("text_words"))
    least, _ = roofline.bound_s(nbytes, ops)
    return 100.0 * least / t["kernel_s"]["K3"]
