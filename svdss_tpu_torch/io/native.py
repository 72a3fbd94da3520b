"""ctypes bindings for the native IO/indexing library (native/*.so).

Equivalent in role to the reference's htslib+libdeflate layer with its
8-thread BGZF pools (bgzf_mt, ping_pong.cpp:249): fast host-side BAM
decompression feeding the Python codec. Falls back silently to the pure
Python path when the library isn't built.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None


def _try_build(native_dir: str) -> None:
    """Build the library in-place when only the sources are present.

    The machine (and any previously built .so) resets between sessions;
    without this, long-running tools silently fall back to the slow
    numpy paths (a 6.2G wide-table build is ~87 min numpy vs ~10 min
    native). make is idempotent and takes seconds."""
    import subprocess
    try:
        subprocess.run(["make", "-s"], cwd=native_dir, check=True,
                       capture_output=True, timeout=300)
    except Exception:
        pass                        # fall through to the Python paths


def load() -> Optional[ctypes.CDLL]:
    # only a successful load is cached: the library may be built after the
    # first (failed) lookup, e.g. by tests/test_native.py's module fixture
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(here, "native", "libsvdss_native.so")
    if not os.path.exists(cand):
        _try_build(os.path.dirname(cand))
    if os.path.exists(cand):
        lib = ctypes.CDLL(cand)
        lib.svdss_bgzf_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.svdss_bgzf_read.restype = ctypes.c_int
        lib.svdss_bam_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
        lib.svdss_bam_scan.restype = ctypes.c_int
        lib.svdss_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "svdss_wide_keys"):    # widebuild.cpp (newer .so)
            lib.svdss_wide_keys.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.svdss_wide_keys.restype = None
            lib.svdss_wide_count.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p]
            lib.svdss_wide_count.restype = None
            lib.svdss_wide_scatter.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.svdss_wide_scatter.restype = ctypes.c_int64
        if hasattr(lib, "svdss_wide_sort"):    # sorted-bucket pass
            lib.svdss_wide_sort.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.svdss_wide_sort.restype = None
        if hasattr(lib, "svdss_search_scan"):
            lib.svdss_search_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.svdss_search_scan.restype = None
            lib.svdss_search_extract.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.svdss_search_extract.restype = None
        if hasattr(lib, "svdss_wide_sort_right"):
            lib.svdss_wide_sort_right.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            lib.svdss_wide_sort_right.restype = None
        if hasattr(lib, "svdss_wide_sort16"):
            lib.svdss_wide_sort16.argtypes = \
                lib.svdss_wide_sort.argtypes
            lib.svdss_wide_sort16.restype = None
        if hasattr(lib, "svdss_wide_sort_heavy"):
            lib.svdss_wide_sort_heavy.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.svdss_wide_sort_heavy.restype = None
        _LIB = lib
    return _LIB


def bgzf_write_all(path: str, data, level: int = 1, n_threads: int = 2,
                   flags: int = 0) -> bool:
    """Compress `data` (bytes-like) to a BGZF file with the native
    parallel deflater. flags: bit 0 set = append (else truncate), bit 1
    set = suppress the BGZF EOF block — 0 writes a whole file in one
    call. Returns False when the native library is unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "svdss_bgzf_write"):
        return False
    if not getattr(lib, "_bgzf_write_bound", False):
        lib.svdss_bgzf_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.svdss_bgzf_write.restype = ctypes.c_int
        lib._bgzf_write_bound = True
    buf = np.frombuffer(data, dtype=np.uint8)
    p8 = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return lib.svdss_bgzf_write(path.encode(), p8, len(buf), level,
                                n_threads, flags) == 0


class _CBuffer:
    """One C allocation of the native library, exposed to numpy through the
    array interface and freed when the last array or view over it goes."""

    def __init__(self, lib, ptr: int, size: int):
        self._lib = lib
        self._ptr = ptr
        self.__array_interface__ = {"shape": (size,), "typestr": "|u1",
                                    "data": (ptr, False), "version": 3}

    def __del__(self):
        self._lib.svdss_free(self._ptr)


def bgzf_read_all(path: str, n_threads: int = 4):
    """Decompress a whole BGZF file with the native parallel inflater.

    Returns a memoryview over the C buffer itself, freed when the last view
    of it goes (no copy: the inflated file is held once), or None when the
    native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    data = ctypes.c_void_p()
    size = ctypes.c_int64()
    rc = lib.svdss_bgzf_read(path.encode(), ctypes.byref(data),
                             ctypes.byref(size), n_threads)
    if rc != 0:
        return None
    return memoryview(np.asarray(_CBuffer(lib, data.value, size.value)))


def bam_scan(data: bytes) -> Optional[np.ndarray]:
    """Record table [n, 8] int64: offset, block_size, tid, pos, flag, mapq,
    l_seq, n_cigar (see native/bamio.cpp)."""
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
    recs = ctypes.c_void_p()
    n = ctypes.c_int64()
    rc = lib.svdss_bam_scan(buf, len(data), ctypes.byref(recs),
                            ctypes.byref(n))
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(
            ctypes.cast(recs, ctypes.POINTER(ctypes.c_int64)),
            shape=(n.value, 8)).copy()
    finally:
        lib.svdss_free(recs)
    return arr
