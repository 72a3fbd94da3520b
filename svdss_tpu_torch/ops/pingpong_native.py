"""ctypes binding for the native host-path ping-pong search.

native/pingpong.cpp runs the exact ping_pong.cpp:4-49 semantics against
the fused flat rank layout, threaded over reads — the role of the
reference's 16-thread CPU search — and owns the index handle. Its capped
entry (``search_batch``) searches a read past its cap again at twice the
cap; it is bench.py's measured CPU baseline (vs_baseline denominator).
The port's one-pass entry (``csrc/pingpong_flat.cpp``,
``search_batch_flat``) searches each read once and returns every SFS; it
backs the ``--no-device`` host search path and the exactness fallback for
device lanes that overflow their emission buffers, ~100x the pure Python
oracle's speed.

Falls back to None when either library is unavailable; callers then use
ops.pingpong_host.ping_pong_search (the annotated Python oracle).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..index.fmd import FMDIndex
from ..index.suffix_array import _load_native
from ..utils.log import logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# native/Makefile's flags
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
             "-pthread"]


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


_FLAT = None
_FLAT_LOCK = threading.Lock()


def _load_flat():
    """The one-pass search library (``csrc/pingpong_flat.cpp``), built
    with g++ into ``build/host/`` when missing or older than its source or
    native/rank.h; None when it cannot be built."""
    global _FLAT
    with _FLAT_LOCK:
        if _FLAT is not None:
            return _FLAT
        src = os.path.join(_PKG, "csrc", "pingpong_flat.cpp")
        native = os.path.join(os.path.dirname(_PKG), "native")
        out_dir = os.path.join(os.path.dirname(_PKG), "build", "host")
        lib_path = os.path.join(out_dir, "libpingpong_flat.so")
        deps = [src] + [os.path.join(native, h)
                        for h in ("rank.h", "sais_impl.h")]
        if (not os.path.exists(lib_path) or max(map(os.path.getmtime, deps))
                > os.path.getmtime(lib_path)):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{lib_path}.tmp{os.getpid()}"
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-I", native, "-o", tmp,
                                src], check=True, capture_output=True,
                               timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                logger.warning("pingpong_flat.cpp not built: %s",
                               getattr(e, "stderr", None) or e)
                return None
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.svdss_ping_pong_batch_flat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
        lib.svdss_ping_pong_batch_flat.restype = ctypes.c_int
        lib.svdss_flat_free.argtypes = [ctypes.c_void_p]
        lib.svdss_flat_free.restype = None
        _FLAT = lib
        return _FLAT


def _pack(encoded: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """The reads' nt6 symbols end to end, each followed by its 0
    sentinel, and the [n + 1] offsets of each read's start."""
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    for i, e in enumerate(encoded):
        offsets[i + 1] = offsets[i] + len(e) + 1
    buf = np.zeros(offsets[-1], dtype=np.uint8)
    for i, e in enumerate(encoded):
        buf[offsets[i]:offsets[i + 1] - 1] = e
    return buf, offsets


class NativeFMD:
    """Native fused-rank FMD handle for host-path searches."""

    def __init__(self, index: FMDIndex, threads: int = 2):
        lib = _load_native()
        if lib is None or not _bind(lib):
            raise RuntimeError("native library unavailable")
        flat = _load_flat()
        if flat is None:
            raise RuntimeError("one-pass search library unavailable")
        self._lib = lib
        self._flat = flat
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
        buf, offsets = _pack(encoded)
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

    def search_batch_flat(self, encoded: List[np.ndarray], overlap: int = -1,
                          threads: int = 2) -> List[List[Tuple[int, int]]]:
        """Ping-pong each nt6 read once; returns per-read (qs, length)
        pairs, every SFS of the read whatever its count (the lists
        search_batch returns)."""
        n = len(encoded)
        if n == 0:
            return []
        buf, offsets = _pack(encoded)
        cnt = np.zeros(n, dtype=np.int64)
        pairs = ctypes.c_void_p()
        total = ctypes.c_int64()
        rc = self._flat.svdss_ping_pong_batch_flat(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n), ctypes.c_int(overlap), ctypes.c_int(threads),
            cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(pairs), ctypes.byref(total))
        if rc != 0:
            raise RuntimeError(f"svdss_ping_pong_batch_flat rc={rc}")
        m = int(total.value)
        try:
            flat = np.ctypeslib.as_array(
                ctypes.cast(pairs, ctypes.POINTER(ctypes.c_int32)),
                shape=(2 * max(m, 1),))[:2 * m].tolist()
        finally:
            self._flat.svdss_flat_free(pairs)
        qs, ln = flat[0::2], flat[1::2]
        ends = np.cumsum(cnt).tolist()
        return [list(zip(qs[a:b], ln[a:b]))
                for a, b in zip([0] + ends[:-1], ends)]


def open_native_fmd(index: FMDIndex, threads: int = 2
                    ) -> Optional[NativeFMD]:
    try:
        return NativeFMD(index, threads)
    except RuntimeError:
        return None
