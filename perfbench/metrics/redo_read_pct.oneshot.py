"""Search driver, in cells that report the search rate: redo_read_pct's
reading (reads the device engine flagged and the host engine redid, in %
of the reads handed in the window), under a name of its own for the
end-to-end metric it moves there."""

from perfbench.metrics.redo_read_pct import read  # noqa: F401
