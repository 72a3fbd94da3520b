"""Scalar host-side ping-pong SFS search — the correctness oracle.

Reimplements the reference algorithm (ping_pong_search, ping_pong.cpp:4-49)
against our FMDIndex. The batched device version (ops/pingpong_jax.py) must
produce identical (query_start, length) pairs; this scalar version exists to
pin the semantics and to unit-test against a naive suffix scan.

Semantics (SURVEY.md §3.3): starting from the read end, search backward until
the current substring is absent from the two-strand reference; then, from the
mismatch position, search forward until absent again; emit that minimal
absent substring P[begin..end]; restart at begin = end - 1 (overlap = -1).

Boundary note: when the whole suffix P[begin..l-1] is present, the reference
reads the NUL terminator and extends by symbol 0 ('$'), whose interval is
(essentially always) empty, terminating with end == l — i.e. the emitted SFS
length sticks one past the read end (ping_pong.cpp:31-37). We reproduce that
by treating extension past the last base as an empty interval.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..index.fmd import FMDIndex
from ..utils.seq import COMP6


def ping_pong_search(index: FMDIndex, P: np.ndarray,
                     overlap: int = -1) -> List[Tuple[int, int]]:
    """SFS (query_start, length) pairs for one nt6-encoded read."""
    P = np.asarray(P, dtype=np.uint8)
    l = int(len(P))
    out: List[Tuple[int, int]] = []
    if l == 0:
        return out
    begin = l - 1
    while begin >= 0:
        # backward: stop at first mismatch
        ik = index.set_intv(int(P[begin]))
        while ik.size != 0 and begin > 0:
            begin -= 1
            ik = index.extend(ik, True)[int(P[begin])]
        if begin == 0 and ik.size != 0:
            break  # whole prefix matches the reference: no SFS here
        # forward from the mismatch position
        end = begin
        ik = index.set_intv(int(P[end]))
        while ik.size != 0:
            end += 1
            if end >= l:
                # sentinel extension: empty (see module docstring)
                break
            ok = index.extend(ik, False)
            ik = ok[int(COMP6[P[end]])]
        out.append((begin, end - begin + 1))
        if begin == 0:
            break
        begin = end + overlap if overlap != 0 else begin - 1
    return out
