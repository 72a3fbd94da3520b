"""Suffix-array construction.

The reference delegates to ropebwt3 (libsais + RLE ropes, CMakeLists.txt:169)
to build its .fmd file. We only need the suffix array transiently, to derive
the BWT and flat occ tables; construction runs on host.

Two backends:
  * a C++ SA-IS implementation (native/sais.cpp) loaded via ctypes — fast
    path for whole chromosomes;
  * a numpy prefix-doubling fallback (O(n log n) with vectorized sorts) —
    always available, used as the correctness oracle for the native one.

Both treat the text as a plain byte string; sentinel symbols (0) may repeat,
ties are broken by suffix content, which yields a BWT whose symbol *counts*
at any rank position >= #sentinels are independent of $-ordering — the only
property the FMD search relies on (see index/fmd.py notes).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_NATIVE = None


def _load_native():
    # only a successful load is cached: the library may be built after the
    # first (failed) lookup, e.g. by tests/test_native.py's module fixture
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", "libsvdss_native.so"),
                 os.path.join(os.path.dirname(__file__), "libsvdss_native.so")):
        if os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.svdss_sais.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64]
            lib.svdss_sais.restype = ctypes.c_int
            if hasattr(lib, "svdss_build_bwt"):
                lib.svdss_build_bwt.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8)]
                lib.svdss_build_bwt.restype = ctypes.c_int
            _NATIVE = lib
            break
    return _NATIVE


def build_bwt_grouped(text: np.ndarray, str_ends: np.ndarray,
                      threads: int = 1,
                      group_max: int = 0) -> "np.ndarray | None":
    """Whole-genome BWT via the native grouped builder (per-group int32
    SA-IS + FM-walk merge; native/bwtbuild.cpp — the role of ropebwt3's
    parallel incremental build, reference main.cpp:34-37).

    text: uint8 nt6 concatenation of strings each ending with a 0
    sentinel; str_ends: int64 exclusive end offsets per string. Texts that
    fit one group (< ~768M symbols by default) get a single content-
    crossing SA-IS, identical to the plain path; larger texts merge groups
    under per-string sentinel semantics, which the FMD search is invariant
    to (see index/fmd.py). Returns None when the native library is absent.
    """
    lib = _load_native()
    if lib is None or not hasattr(lib, "svdss_build_bwt"):
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    str_ends = np.ascontiguousarray(str_ends, dtype=np.int64)
    bwt = np.empty(len(text), dtype=np.uint8)
    rc = lib.svdss_build_bwt(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(text)),
        str_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(str_ends)),
        ctypes.c_int32(threads), ctypes.c_int64(group_max),
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"svdss_build_bwt failed (rc={rc})")
    return bwt


def suffix_array_doubling(t: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (numpy, O(n log^2 n) worst case)."""
    t = np.asarray(t, dtype=np.uint8)
    n = len(t)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    rank = t.astype(np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        sa = np.lexsort((key2, rank))
        new_rank = np.empty(n, dtype=np.int64)
        diff = (rank[sa[1:]] != rank[sa[:-1]]) | \
               (key2[sa[1:]] != key2[sa[:-1]])
        new_rank[sa] = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(diff)])
        rank = new_rank
        if rank[sa[-1]] == n - 1:
            return sa.astype(np.int64)
        k *= 2


def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8 text; uses the native SA-IS when available."""
    t = np.ascontiguousarray(t, dtype=np.uint8)
    n = len(t)
    lib = _load_native()
    if lib is not None and n > 1:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.svdss_sais(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n))
        if rc == 0:
            return sa
    return suffix_array_doubling(t)
