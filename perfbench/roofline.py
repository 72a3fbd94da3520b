"""The least time of a kernel's work on one H100, and the work of K3 and
K4.

Frozen copy of the bound rule of ``svdss_tpu_torch/tools/common.py`` at
commit 2516ced (``bound_ms``, ``anchor_bytes_ops`` and the operation
counts), with one change: the operations are held to Hopper's int32 issue
rate, not to the fp32 rate that file uses. Peaks (one H100 SXM, NVIDIA's
data sheet and the CUDA programming guide's throughput table, at the
700 W limit):

- HBM: 3.35e12 B/s;
- int32 operations: 132 SMs x 64 a clock x 1.98 GHz = 16.7e12 /s (fp32
  is twice that, 67e12 with FMA counted as two; the anchor rounds are
  integer work).

A kernel's least time is the larger of its bytes over the HBM rate and its
operations over the int32 rate; its roofline share is that least time over
its measured device time.
"""

from __future__ import annotations

from typing import Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# an anchor round's state machine outside its loops, and a verify step per
# compared symbol (two fetches, the compare, the loop test)
OPS_PER_ANCHOR_ROUND = 60
OPS_PER_COMPARED_SYMBOL = 4
TABLE_ROW_BYTES = 16
TEXT_ROW_BYTES = 64
EMISSION_BYTES = 8
# K4's per-read scalars: offset (8) and length (4) in, count (4) and flags
# (1) out
K4_READ_SCALAR_BYTES = 8 + 4 + 4 + 1
# K3's per-lane scalars: length (4) in, count (4), overflow (1) and
# incomplete (1) out; and per launch its round count (4) out
K3_LANE_SCALAR_BYTES = 4 + 4 + 1 + 1
K3_LAUNCH_SCALAR_BYTES = 4


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations": which peak bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_bytes_ops(read_symbols: int, reads: int, launches: int,
                 rounds: int, table_rows: int, text_rows: int,
                 compared_symbols: int, emissions: int,
                 table_bytes: Optional[int] = None,
                 text_bytes: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) that K4's launches need: each read's symbols
    and scalars once, 16 B a table row and 64 B a text row its rounds
    touched (each launch at most the whole table or text, when their sizes
    are given), 8 B an emission; 60 operations a round and 4 a compared
    symbol."""
    rows = TABLE_ROW_BYTES * table_rows
    if table_bytes is not None:
        rows = min(rows, launches * table_bytes)
    text = TEXT_ROW_BYTES * text_rows
    if text_bytes is not None:
        text = min(text, launches * text_bytes)
    nbytes = (read_symbols + K4_READ_SCALAR_BYTES * reads + rows + text
              + EMISSION_BYTES * emissions)
    ops = (rounds * OPS_PER_ANCHOR_ROUND
           + compared_symbols * OPS_PER_COMPARED_SYMBOL)
    return nbytes, ops


def k3_bytes_ops(lane_symbols: int, lanes: int, launches: int,
                 rounds: int, table_rows: int, text_rows: int,
                 compared_symbols: int, emissions: int,
                 table_bytes: Optional[int] = None,
                 text_bytes: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) that K3's launches need, by the rule
    ``tools/common.py`` ``anchor_bytes_ops`` gives K3: each lane's symbols
    with its sentinel (`lane_symbols`, padding lanes included) and its
    scalars once, each launch's round count, 16 B a table row and 64 B a
    text row its rounds touched (each launch at most the whole table or
    text, when their sizes are given), 8 B an emission; 60 operations a
    round and 4 a compared symbol."""
    rows = TABLE_ROW_BYTES * table_rows
    if table_bytes is not None:
        rows = min(rows, launches * table_bytes)
    text = TEXT_ROW_BYTES * text_rows
    if text_bytes is not None:
        text = min(text, launches * text_bytes)
    nbytes = (lane_symbols + K3_LANE_SCALAR_BYTES * lanes
              + K3_LAUNCH_SCALAR_BYTES * launches + rows + text
              + EMISSION_BYTES * emissions)
    ops = (rounds * OPS_PER_ANCHOR_ROUND
           + compared_symbols * OPS_PER_COMPARED_SYMBOL)
    return nbytes, ops
