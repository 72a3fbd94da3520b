"""Anchor-verify SFS search: k-mer anchors + direct text verification.

Host-side index build and the serial reference implementation of the
anchor algorithm. The FM ping-pong search (ops/pingpong_host.py, exactly
reference ping_pong.cpp:4-49) pays one rank gather PER BASE walked; on the
TPU that gather is the entire cost of the search stage (~61 ns/row into an
HBM-resident table, measured). This module reformulates the identical
semantics in terms of *matching statistics* so a walk resolves in a
handful of gathers instead of one per base:

  backward phase at anchor r    ==  ms(r)  = max m: P[r-m+1..r] occurs
  forward  phase at start  b    ==  fms(b) = max m: P[b..b+m-1]  occurs
  emitted SFS (b, e)            ==  b = r - ms(r),  e = b + fms(b)

and matching statistics resolve against three flat tables over the
two-strand text T' (the SAME text the FMD index is built from, so
"occurs" is bit-identical):

  * meta[4^k, 2]   — (count, aux) per k-mer; aux = the single occurrence
                     position when count == 1 (the common case — no
                     second lookup), else the poslist offset;
  * poslist[n]     — occurrence start positions grouped by k-mer;
  * level bitmaps  — presence of j-mers for j in (j0, k), where j0 is the
                     largest length at which EVERY ACGT j-mer occurs
                     (so m >= j0 needs no lookup at all);
  * the text itself — occurrence candidates are verified/extended by
                     direct comparison, sequential in memory.

m >= k cases verify against <= CMAX occurrence positions; absent k-mers
(m < k) resolve by the level-bitmap cascade. Reads whose relevant window
contains a non-ACGT symbol, or whose k-mer count exceeds CMAX, are flagged
for the exact FM fallback path (native host engine) — semantics are never
approximated.

The device implementation is ops/anchor_jax.py; this serial version is
its semantic model and is itself pinned against the FM oracle by
tests/test_anchor.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_CMAX = 16


class NeedsFallback(Exception):
    """Read needs the exact FM path (N in a window / repeat-heavy k-mer)."""


def pick_k(n: int) -> int:
    """Anchor k-mer size: ~log4(n) keeps E[count] ~= 1 while the direct
    meta table (4^k rows) stays a few bytes per text symbol."""
    k = 8
    while 4 ** k < n and k < 14:
        k += 1
    return k


def text_keys(text: np.ndarray, k: int) -> np.ndarray:
    """keys[p] = key of the window ending at p (kmer_keys convention:
    last symbol at 4^0), -1 when out of range or containing non-ACGT."""
    t = text.astype(np.int64)
    n = len(t)
    keys = np.zeros(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    for j in range(k):
        sh = np.zeros_like(t)
        sh[j:] = t[: n - j] if j else t
        keys += (sh - 1) * (4 ** j)
        ok &= (sh >= 1) & (sh <= 4)
    ok[: k - 1] = False
    return np.where(ok, keys, -1).astype(np.int64)


@dataclasses.dataclass
class AnchorIndex:
    """Host-resident anchor tables (device layout in ops/anchor_jax.py)."""
    text: np.ndarray              # uint8 nt6, the two-strand text
    k: int
    j0: int                       # all ACGT j-mers occur for j <= j0
    meta: np.ndarray              # [4^k, 2] int32: (count, pos-or-start)
    poslist: np.ndarray           # [n_multi] int32 window starts
    levels: dict                  # j -> packed presence bitmap uint32[...]
    cmax: int = DEFAULT_CMAX
    heavy_rate: float = -1.0      # position-weighted P(phase over cmax);
                                  # -1 = unknown (pre-round-4 artifact)

    @property
    def n(self) -> int:
        return len(self.text)

    def level_present(self, j: int, key: int) -> bool:
        if j <= self.j0:
            return True
        bm = self.levels[j]
        return bool((bm[key >> 5] >> (key & 31)) & 1)

    def save(self, path: str) -> None:
        """Persist alongside the FMD index (uncompressed npz: load is
        mmap-speed, and the tables don't compress usefully anyway)."""
        np.savez(path, text=self.text, meta=self.meta,
                 poslist=self.poslist, cmax=np.int32(self.cmax),
                 heavy_rate=np.float64(self.heavy_rate),
                 k=np.int32(self.k), j0=np.int32(self.j0),
                 level_js=np.asarray(sorted(self.levels), dtype=np.int32),
                 **{f"level_{j}": bm for j, bm in self.levels.items()})

    @classmethod
    def load(cls, path: str) -> "AnchorIndex":
        z = np.load(path)
        levels = {int(j): z[f"level_{int(j)}"] for j in z["level_js"]}
        return cls(text=z["text"], k=int(z["k"]), j0=int(z["j0"]),
                   meta=z["meta"], poslist=z["poslist"], levels=levels,
                   cmax=int(z["cmax"]),
                   heavy_rate=float(z["heavy_rate"])
                   if "heavy_rate" in z.files else -1.0)


def _build_narrow_native(text: np.ndarray, k: int, cmax: int,
                         lib) -> "AnchorIndex":
    """build_anchor_index through the native widebuild.cpp passes
    (identical layout/ordering to the numpy path: grouped counting-sort
    poslist ascending per key, singleton positions inline). The numpy
    path's full-width argsort measured ~307 s at 100 Mbp on this host;
    the native passes are ~10x faster."""
    n = len(text)
    nk = 4 ** k
    keys = np.empty(n, dtype=np.int32)
    cleanc = np.empty(n, dtype=np.uint8)
    lib.svdss_wide_keys(text.ctypes.data, n, k,
                        keys.ctypes.data, cleanc.ctypes.data)
    counts64 = np.zeros(nk, dtype=np.int64)
    lib.svdss_wide_count(keys.ctypes.data, cleanc.ctypes.data, n, k,
                         counts64.ctypes.data)
    counts = counts64.astype(np.int32)
    single = counts == 1
    multi = counts > 1
    seg = np.zeros(nk + 1, dtype=np.int64)
    np.cumsum(np.where(multi, counts64, 0), out=seg[1:])
    np_total = int(seg[-1])
    aux = np.zeros(nk, dtype=np.uint32)
    cursor = seg[:-1].copy()
    poslist_u = np.empty(np_total, dtype=np.uint32)
    keep_u8 = multi.astype(np.uint8)
    single_u8 = single.astype(np.uint8)
    written = lib.svdss_wide_scatter(
        keys.ctypes.data, cleanc.ctypes.data, n, k,
        keep_u8.ctypes.data, cursor.ctypes.data, poslist_u.ctypes.data,
        single_u8.ctypes.data, aux.ctypes.data)
    assert written == np_total, "kept-entry count mismatch"
    meta = np.zeros((nk, 2), dtype=np.int32)
    meta[:, 0] = counts
    meta[single, 1] = aux[single].astype(np.int32)
    meta[multi, 1] = seg[:-1][multi].astype(np.int32)
    poslist = poslist_u.astype(np.int32)
    del poslist_u, cursor, keep_u8, single_u8, aux

    levels = {}
    j0 = k - 1
    for j in range(k - 1, 0, -1):
        vj = keys[cleanc >= j] & np.int32(4 ** j - 1)
        present = np.zeros(4 ** j, dtype=bool)
        present[vj] = True
        if present.all():
            j0 = j
            break
        bm = np.zeros((4 ** j + 31) // 32, dtype=np.uint32)
        idx = np.nonzero(present)[0]
        np.bitwise_or.at(bm, idx >> 5, np.uint32(1) << (idx & 31))
        levels[j] = bm
        j0 = j - 1
    heavy_rate = float(counts64[counts64 > cmax].sum()
                       / max(1, counts64.sum()))
    return AnchorIndex(text=text, k=k, j0=j0, meta=meta, poslist=poslist,
                       levels=levels, cmax=cmax, heavy_rate=heavy_rate)


def build_anchor_index(text: np.ndarray, k: Optional[int] = None,
                       cmax: int = DEFAULT_CMAX) -> AnchorIndex:
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    if k is None:
        k = pick_k(n)
    assert n < 2 ** 31, "anchor tables are narrow-coordinate (v1)"
    from .anchor_wide import _native_wide
    lib = _native_wide()
    if lib is not None and 1 <= k <= 15:
        return _build_narrow_native(text, k, cmax, lib)
    # rawkeys[p] = base-4 value of the k symbols ending at p (junk where
    # the window is dirty), clean[p] = ACGT run length ending at p.
    # key_j = rawkeys mod 4^j wherever clean >= j — older symbols
    # contribute multiples of 4^j and vanish mod 4^j. Built by doubling
    # (value of an (a+b)-window = a-window shifted by b digits + b-window)
    # in O(log k) passes instead of k.
    def _shift_combine(a: np.ndarray, b: np.ndarray, mb: int) -> np.ndarray:
        out = b.copy()
        out[mb:] += a[: n - mb] << (2 * mb)
        return out

    pow2 = {1: text.astype(np.int64) - 1}
    m = 1
    while m * 2 <= k:
        pow2[m * 2] = _shift_combine(pow2[m], pow2[m], m)
        m *= 2
    rawkeys, width = None, 0
    for b in sorted(pow2, reverse=True):
        if not k & b:
            continue
        if rawkeys is None:
            rawkeys, width = pow2[b], b
        else:
            rawkeys = _shift_combine(rawkeys, pow2[b], b)
            width += b
    del pow2
    bad = (text < 1) | (text > 4)
    last_bad = np.maximum.accumulate(
        np.where(bad, np.arange(n, dtype=np.int64), -1))
    clean = np.arange(n, dtype=np.int64) - last_bad
    valid = clean >= k
    vkeys = rawkeys[valid].astype(np.int32)   # < 4^14: int32 radix-sorts
                                              # ~1.4x faster than int64
    starts = (np.nonzero(valid)[0] - (k - 1)).astype(np.int32)
    counts = np.bincount(vkeys, minlength=4 ** k).astype(np.int32)
    # poslist grouped by key (counting sort); singletons inline in meta
    order = np.argsort(vkeys, kind="stable")
    grouped = starts[order]
    cum = np.zeros(4 ** k + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    meta = np.zeros((4 ** k, 2), dtype=np.int32)
    meta[:, 0] = counts
    single = counts == 1
    meta[single, 1] = grouped[cum[:-1][single]]
    multi = counts > 1
    # compact the poslist to multi-occurrence k-mers only
    multi_keys = np.nonzero(multi)[0]
    seg_lens = counts[multi_keys].astype(np.int64)
    new_starts = np.zeros(len(multi_keys), dtype=np.int64)
    if len(multi_keys):
        np.cumsum(seg_lens[:-1], out=new_starts[1:])
    meta[multi_keys, 1] = new_starts.astype(np.int32)
    # grouped is already key-ordered; the compact poslist is simply the
    # entries whose key is multi-occurrence, in place
    entry_multi = multi[vkeys[order]]
    poslist = np.ascontiguousarray(grouped[entry_multi])
    # level bitmaps for j in (j0, k): j0 = largest all-present level
    levels = {}
    j0 = k - 1
    for j in range(k - 1, 0, -1):
        vj = rawkeys[clean >= j] % (4 ** j)
        present = np.zeros(4 ** j, dtype=bool)
        present[vj] = True
        if present.all():
            j0 = j
            break
        bm = np.zeros((4 ** j + 31) // 32, dtype=np.uint32)
        idx = np.nonzero(present)[0]
        np.bitwise_or.at(bm, idx >> 5, np.uint32(1) << (idx & 31))
        levels[j] = bm
        j0 = j - 1
    # position-weighted phase-heavy rate: P(a uniformly placed anchor
    # phase lands on an over-cmax k-mer) — the per-read fallback driver
    # on repeat-rich genomes; counts here are two-strand already
    heavy_rate = float(counts[counts > cmax].astype(np.int64).sum()
                       / max(1, counts.astype(np.int64).sum()))
    return AnchorIndex(text=text, k=k, j0=j0, meta=meta, poslist=poslist,
                       levels=levels, cmax=cmax, heavy_rate=heavy_rate)


# ------------------------------------------------------------- host search

def _occurrences(idx: AnchorIndex, key: int) -> np.ndarray:
    cnt = int(idx.meta[key, 0])
    aux = int(idx.meta[key, 1])
    if cnt == 1:
        return np.array([aux], dtype=np.int32)
    return idx.poslist[aux:aux + cnt]


def _clean_run(P: np.ndarray, p: int, need: int) -> int:
    """Number of consecutive ACGT symbols ending at p, counted down to at
    most `need`."""
    run = 0
    while run < need and p - run >= 0 and 1 <= P[p - run] <= 4:
        run += 1
    return run


def _key_ending(P: np.ndarray, p: int, j: int) -> int:
    key = 0
    for i in range(j):
        key += (int(P[p - i]) - 1) * (4 ** i)
    return key


def ms_left(idx: AnchorIndex, P: np.ndarray, r: int) -> int:
    """max m such that P[r-m+1..r] occurs in the text (m <= r+1).

    Raises NeedsFallback when a non-ACGT symbol or a > cmax k-mer blocks
    the anchor resolution.
    """
    T = idx.text
    k, j0 = idx.k, idx.j0
    maxlen = r + 1
    if maxlen <= j0:
        clean = _clean_run(P, r, maxlen)
        if clean < maxlen:
            raise NeedsFallback
        return maxlen
    clean = _clean_run(P, r, min(k, maxlen))
    if clean < min(k, maxlen):
        raise NeedsFallback
    if maxlen >= k:
        key = _key_ending(P, r, k)
        cnt = int(idx.meta[key, 0])
        if cnt == 0:
            for j in range(k - 1, j0, -1):
                if idx.level_present(j, key % (4 ** j)):
                    return j
            return j0
        if cnt > idx.cmax:
            raise NeedsFallback
        cap = maxlen - k  # read-start cap on the left extension
        best = 0
        for p in _occurrences(idx, key):
            p = int(p)
            e = 0
            while (e < cap and p - 1 - e >= 0
                   and T[p - 1 - e] == P[r - k - e] and P[r - k - e] != 0):
                e += 1
            best = max(best, e)
            if best == cap:
                break
        return k + best
    # j0 < maxlen < k: bitmap cascade over the feasible lengths
    for j in range(maxlen, j0, -1):
        if idx.level_present(j, _key_ending(P, r, j)):
            return j
    return j0


def fms_right(idx: AnchorIndex, P: np.ndarray, l: int, b: int) -> int:
    """max m such that P[b..b+m-1] occurs (m <= l-b)."""
    T = idx.text
    k, j0 = idx.k, idx.j0
    maxlen = l - b
    if maxlen <= j0:
        clean = _clean_run(P, b + maxlen - 1, maxlen)
        if clean < maxlen:
            raise NeedsFallback
        return maxlen
    clean = _clean_run(P, b + min(k, maxlen) - 1, min(k, maxlen))
    if clean < min(k, maxlen):
        raise NeedsFallback
    if maxlen >= k:
        key = _key_ending(P, b + k - 1, k)
        cnt = int(idx.meta[key, 0])
        if cnt == 0:
            for j in range(k - 1, j0, -1):
                if idx.level_present(j, _key_ending(P, b + j - 1, j)):
                    return j
            return j0
        if cnt > idx.cmax:
            raise NeedsFallback
        cap = maxlen - k  # read-end cap on the right extension
        best = 0
        n = idx.n
        for p in _occurrences(idx, key):
            p = int(p)
            e = 0
            while (e < cap and p + k + e < n
                   and T[p + k + e] == P[b + k + e] and P[b + k + e] != 0):
                e += 1
            best = max(best, e)
            if best == cap:
                break
        return k + best
    for j in range(maxlen, j0, -1):
        if idx.level_present(j, _key_ending(P, b + j - 1, j)):
            return j
    return j0


def anchor_search(idx: AnchorIndex, P: np.ndarray,
                  overlap: int = -1) -> List[Tuple[int, int]]:
    """SFS (query_start, length) pairs for one nt6 read — identical output
    to ops.pingpong_host.ping_pong_search over the same text.

    Raises NeedsFallback for reads the anchor path cannot resolve exactly.
    """
    P = np.asarray(P, dtype=np.uint8)
    l = int(len(P))
    out: List[Tuple[int, int]] = []
    if l == 0:
        return out
    begin = l - 1
    while begin >= 0:
        m = ms_left(idx, P, begin)
        if m == begin + 1:
            break  # whole prefix occurs: no SFS here
        b = begin - m
        fm = fms_right(idx, P, l, b)
        end = b + fm
        out.append((b, end - b + 1))
        if b == 0:
            break
        begin = end + overlap if overlap != 0 else b - 1
    return out
