"""ctypes binding for the native host-path ping-pong search.

native/pingpong.cpp runs the exact ping_pong.cpp:4-49 semantics against
the fused flat rank layout, threaded over reads — the role of the
reference's 16-thread CPU search. It backs:

  * the ``--no-device`` host search path (and the exactness fallback for
    device lanes that overflow their emission buffers), ~100x the pure
    Python oracle's speed;
  * bench.py's measured CPU baseline (vs_baseline denominator).

Falls back to None when the native library is unavailable; callers then
use ops.pingpong_host.ping_pong_search (the annotated Python oracle).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..index.fmd import FMDIndex
from ..index.suffix_array import _load_native


def _bind(lib) -> bool:
    if not hasattr(lib, "svdss_fmd_create"):
        return False
    if getattr(lib, "_pingpong_bound", False):
        return True
    lib.svdss_fmd_create.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int]
    lib.svdss_fmd_create.restype = ctypes.c_void_p
    lib.svdss_fmd_destroy.argtypes = [ctypes.c_void_p]
    lib.svdss_ping_pong_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.svdss_ping_pong_batch.restype = ctypes.c_int
    lib._pingpong_bound = True
    return True


class NativeFMD:
    """Native fused-rank FMD handle for host-path searches."""

    def __init__(self, index: FMDIndex, threads: int = 2):
        lib = _load_native()
        if lib is None or not _bind(lib):
            raise RuntimeError("native library unavailable")
        self._lib = lib
        bwt = np.ascontiguousarray(index.bwt_symbols())
        self._handle = lib.svdss_fmd_create(
            bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(index.n), ctypes.c_int(threads))
        if not self._handle:
            raise RuntimeError("svdss_fmd_create failed")

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.svdss_fmd_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def search_batch(self, encoded: List[np.ndarray], overlap: int = -1,
                     threads: int = 2, cap: int = 512
                     ) -> List[List[Tuple[int, int]]]:
        """Ping-pong each nt6 read; returns per-read (qs, length) pairs.

        Reads whose SFS count exceeds cap re-run with a doubled cap (rare;
        exactness guaranteed either way)."""
        n = len(encoded)
        if n == 0:
            return []
        offsets = np.zeros(n + 1, dtype=np.int64)
        for i, e in enumerate(encoded):
            offsets[i + 1] = offsets[i] + len(e) + 1
        buf = np.zeros(offsets[-1], dtype=np.uint8)
        for i, e in enumerate(encoded):
            buf[offsets[i]:offsets[i + 1] - 1] = e
        qs = np.zeros((n, cap), dtype=np.int32)
        ln = np.zeros((n, cap), dtype=np.int32)
        cnt = np.zeros(n, dtype=np.int32)
        rc = self._lib.svdss_ping_pong_batch(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n), ctypes.c_int(overlap), ctypes.c_int(threads),
            ctypes.c_int32(cap),
            qs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"svdss_ping_pong_batch rc={rc}")
        out: List[List[Tuple[int, int]]] = []
        redo = [i for i in range(n) if cnt[i] < 0]
        redo_res = {}
        if redo:
            sub = self.search_batch([encoded[i] for i in redo], overlap,
                                    threads, cap * 2)
            redo_res = dict(zip(redo, sub))
        for i in range(n):
            if cnt[i] < 0:
                out.append(redo_res[i])
            else:
                k = int(cnt[i])
                out.append(list(zip(qs[i, :k].tolist(), ln[i, :k].tolist())))
        return out


def open_native_fmd(index: FMDIndex, threads: int = 2
                    ) -> Optional[NativeFMD]:
    try:
        return NativeFMD(index, threads)
    except RuntimeError:
        return None
