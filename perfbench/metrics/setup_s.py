"""Set-up: process start to the first hand-off (tables loaded, reads made,
device tables laid out and uploaded, one batch to warm up), in seconds
(host clock). A checkout's first run also builds the index and tables: that
build is left out (reported apart as index_build_s on standard error)."""


def read(ctx):
    return float(ctx.setup_s)
