"""ctypes binding for the native threaded POA consensus (native/poa.cpp).

Bit-exact with the Python oracle `ops.poa.poa_consensus` (same convex-gap
DP, traceback tie-breaks, merge and heaviest-bundle selection — pinned by
tests/test_poa_native.py), ~100x faster per cluster and threaded across
clusters (the reference's omp-over-clusters, caller.cpp:312). Falls back
to None when the native library is unavailable; callers then map the
Python oracle over clusters.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..index.suffix_array import _load_native


def _bind(lib) -> bool:
    if not hasattr(lib, "svdss_poa_batch"):
        return False
    if getattr(lib, "_poa_bound", False):
        return True
    lib.svdss_poa_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.svdss_poa_batch.restype = ctypes.c_int
    lib._poa_bound = True
    return True


def poa_consensus_batch(clusters: Sequence[Sequence[str]],
                        threads: int = 2) -> Optional[List[str]]:
    """Consensus per cluster of sequences; None if the library is absent.

    Order and content match [poa_consensus(c) for c in clusters] exactly.
    """
    lib = _load_native()
    if lib is None or not _bind(lib):
        return None
    n_clusters = len(clusters)
    if n_clusters == 0:
        return []
    seq_off = [0]
    cl_off = [0]
    parts = []
    for cl in clusters:
        for s in cl:
            parts.append(s.encode())
            seq_off.append(seq_off[-1] + len(parts[-1]))
        cl_off.append(cl_off[-1] + len(cl))
    seq_off_a = np.asarray(seq_off, dtype=np.int64)
    cl_off_a = np.asarray(cl_off, dtype=np.int64)
    buf = np.frombuffer(b"".join(parts), dtype=np.uint8) if parts else \
        np.zeros(1, dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    out_buf = np.zeros(max(1, int(seq_off_a[-1])), dtype=np.uint8)
    out_len = np.zeros(n_clusters, dtype=np.int32)
    rc = lib.svdss_poa_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seq_off_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(seq_off_a) - 1),
        cl_off_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_clusters), ctypes.c_int(max(1, threads)),
        out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    out: List[str] = []
    for i in range(n_clusters):
        s0 = cl_off_a[i]
        if cl_off_a[i + 1] == s0:
            out.append("")
            continue
        base = int(seq_off_a[s0])
        out.append(out_buf[base:base + int(out_len[i])].tobytes().decode())
    return out
