"""Device, in cells that report the search rate: device_idle_pct's
reading (the share of the traced window in which no kernel, memcpy or
memset ran, in %), under a name of its own for the end-to-end metric it
moves there."""

from perfbench.metrics.device_idle_pct import read  # noqa: F401
