"""Anchor device tables: the searcher's construction (layout and upload
by build_device_anchor), host clock ending in a device synchronize."""


def read(ctx):
    return float(ctx.table_upload_s)
