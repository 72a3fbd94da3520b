"""Whole-genome (wide-coordinate) anchor-verify tables + host oracle.

The narrow anchor engine (ops/anchor.py) stores tables over the full
TWO-STRAND text, whose coordinates must fit int32 (`n < 2^31`,
anchor.py) — at the HG002 north-star scale (GRCh38 two strands =
~6.2G symbols) both the coordinates and the HBM budget break: one
position entry per text symbol alone is ~25 GB.

This module rebuilds the same semantics at whole-genome scale on two
ideas:

1. **Forward-strand storage, both-orientation query.** The two-strand
   substring set is closed under reverse complement, and every
   occurrence is either a forward-strand occurrence of S or a
   forward-strand occurrence of RC(S) (bijectively, so counts add:
   occ2(S) = occf(S) + occf(RC(S))). Storing tables over the forward
   text only (~3.1G symbols — coordinates fit uint32) and resolving
   each matching-statistics phase as the max over the two orientations
   is EXACTLY the two-strand search, at half the memory, with no
   split-limb arithmetic. Presence bitmaps are OR-closed over RC at
   build time so the sub-k cascade stays a single lookup.

2. **Over-cmax pruning + per-phase host resolve.** At k=14 a 3.1G
   forward text averages ~11.5 occurrences per k-mer per strand, so
   (unlike the narrow engine, where over-cmax k-mers are rare) heavy
   anchors are a steady fraction of phases and falling back per READ
   would send everything to the host. Instead: k-mers whose two-strand
   count exceeds cmax are dropped from the poslist entirely (the
   poslist shrinks by the heavy tail, the dominant HBM term) but their
   occurrence lists are KEPT host-side (``heavy_*`` arrays, never
   uploaded); a phase that lands on one is resolved EXACTLY on the
   host (``make_heavy_resolver`` — a vectorized max-extension over the
   heavy list, no FM index needed) while the device lane parks — see
   ops/anchor_wide_jax.py's parked-phase waves. Output remains
   bit-identical to the ping-pong oracle.

3. **Suffix-ordered buckets.** Each kept k-mer bucket is sorted by the
   text FOLLOWING the occurrence (right order: the suffix starting at
   p+k), and a per-entry inverse permutation (``leftidx``, 1 byte)
   gives the bucket in reversed-prefix order (the text BEFORE p, read
   leftward). Max-extension over a bucket then becomes a binary
   search with text probes — the probe path's max LCP with the query
   IS the bucket max (suffix-array insertion-point argument) — so
   per-anchor cost is O(log cnt) instead of O(cnt) and cmax can rise
   to 254 without linear-scan blowup (the 8x one-shot gap between
   100 Mbp and 6.2G tracked mean bucket depth; ARCHITECTURE.md).

Memory at GRCh38 scale (3.1G forward symbols, k=14, cmax=32):
counts uint8 268 MB + aux uint32 1.07 GB + pruned poslist ~11 GB +
nibble-packed text 1.55 GB ~= 14 GB — inside one v5e chip's HBM.

Reference: ping_pong.cpp:4-49 (semantics); BASELINE.md north star
(scale). The narrow module ops/anchor.py documents the
matching-statistics reformulation itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from .anchor import NeedsFallback

WIDE_K = 14
# default prune bound: with suffix-ordered buckets a probe costs
# O(log cnt), so cmax maximizes device residency on repeat-rich
# genomes — dispersed-repeat families (LINE/SINE-class, counts in the
# thousands) stay device-resident and only satellite-core k-mers
# (counts past 65534, the uint16 saturation/leftidx bound) park for
# host resolve. Pre-sorted-bucket builds used 32-44; cmax <= 254
# selects the 1-byte-leftidx table format.
WIDE_CMAX = 65534


def rc_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse-complement of base-4 k-mer keys (digit i =
    symbol k-1-i, the text_keys convention): digits reversed and
    complemented (x -> 3-x)."""
    out = np.zeros_like(keys)
    v = keys.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


def rc_key_scalar(key: int, k: int) -> int:
    out = 0
    v = key
    for _ in range(k):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


@dataclasses.dataclass
class AnchorIndexWide:
    """Host-resident wide anchor tables (forward strand only)."""
    text: np.ndarray              # uint8 nt6 forward text
    k: int
    j0: int                       # all two-strand ACGT j-mers occur, j<=j0
    cnts: np.ndarray              # [4^k] forward counts — uint8
                                  # (sat. 255) when cmax <= 254, uint16
                                  # (sat. 65535) for the deep-residency
                                  # builds (cmax up to 65534)
    aux: np.ndarray               # [4^k] uint32: pos (cnt==1) / offset
    poslist: np.ndarray           # [np] uint32 starts (pruned; grouped by
                                  # key, right-suffix order inside a bucket
                                  # when leftidx is present, else position
                                  # ascending — legacy artifacts)
    levels: dict                  # j -> packed two-strand presence bitmap
    cmax: int = WIDE_CMAX
    heavy_rate: float = -1.0      # position-weighted P(phase over cmax);
                                  # -1 = unknown (pre-round-4 artifact)
    # sorted-bucket + heavy-store extension (None on legacy artifacts):
    leftidx: Optional[np.ndarray] = None    # [np] uint8: slot off+m holds
                                            # the bucket-local index of the
                                            # m-th entry in LEFT order
    heavy_keys: Optional[np.ndarray] = None  # sorted int64 pruned keys
    heavy_offs: Optional[np.ndarray] = None  # int64 [nh+1] prefix offsets
    heavy_poslist: Optional[np.ndarray] = None  # uint32 pruned positions
    # host-only heavy bucket ORDER (raw-nt6-byte comparator — exact for
    # the oracle's N-matching semantics, unlike the device buckets'
    # 2-bit class order): heavy_poslist right-sorted per bucket, with
    # heavy_leftperm[off+m] = bucket-local index of the m-th entry in
    # left order. None on stores built before the sorted resolver.
    heavy_leftperm: Optional[np.ndarray] = None  # uint32
    # right-order-only tables (sort_buckets="right"): poslist IS in
    # right-suffix order but no leftidx was emitted — the GRCh38-fit
    # format (leftidx alone is ~1 B/entry ~= 3.1 GB at 3.1G forward
    # symbols, past one v5e's HBM with the rest of the tables). The
    # device engine binary-probes orientation A and scans orientation B
    # linearly (ops/anchor_wide_jax.py right_only).
    right_sorted: bool = False

    @property
    def n(self) -> int:
        return len(self.text)

    def total_count(self, key: int) -> int:
        """Two-strand count of a k-mer (saturating at 255+)."""
        return int(self.cnts[key]) + int(self.cnts[rc_key_scalar(key,
                                                                 self.k)])

    def level_present(self, j: int, key: int) -> bool:
        if j <= self.j0:
            return True
        bm = self.levels[j]
        return bool((bm[key >> 5] >> (key & 31)) & 1)

    def occurrences(self, key: int) -> np.ndarray:
        """Forward-strand occurrence positions of one k-mer (empty when
        pruned as heavy — callers must have checked total_count)."""
        c = int(self.cnts[key])
        if c == 0:
            return np.zeros(0, dtype=np.uint32)
        if c == 1:
            return np.array([self.aux[key]], dtype=np.uint32)
        off = int(self.aux[key])
        if off == 0xFFFFFFFF:          # pruned (heavy k-mer)
            return np.zeros(0, dtype=np.uint32)
        return self.poslist[off:off + c]

    def heavy_occurrences(self, key: int) -> np.ndarray:
        """Forward-strand occurrences of a PRUNED (over-cmax, cnt>=2)
        k-mer from the host-only heavy store; empty when the key is not
        heavy or the store is absent (legacy artifact)."""
        if self.heavy_keys is None or len(self.heavy_keys) == 0:
            return np.zeros(0, dtype=np.uint32)
        i = int(np.searchsorted(self.heavy_keys, key))
        if i >= len(self.heavy_keys) or int(self.heavy_keys[i]) != key:
            return np.zeros(0, dtype=np.uint32)
        return self.heavy_poslist[int(self.heavy_offs[i]):
                                  int(self.heavy_offs[i + 1])]

    def all_occurrences(self, key: int) -> np.ndarray:
        """Forward occurrences of any k-mer: inline singleton, kept
        bucket, or heavy store."""
        c = int(self.cnts[key])
        if c == 0:
            return np.zeros(0, dtype=np.uint32)
        if c == 1:
            return np.array([self.aux[key]], dtype=np.uint32)
        if int(self.aux[key]) == 0xFFFFFFFF:
            return self.heavy_occurrences(key)
        return self.poslist[int(self.aux[key]):int(self.aux[key]) + c]

    def save(self, path: str) -> None:
        extra = {}
        if self.leftidx is not None:
            extra["leftidx"] = self.leftidx
        if self.heavy_keys is not None:
            extra["heavy_keys"] = self.heavy_keys
            extra["heavy_offs"] = self.heavy_offs
            extra["heavy_poslist"] = self.heavy_poslist
        if self.heavy_leftperm is not None:
            extra["heavy_leftperm"] = self.heavy_leftperm
        np.savez(path, text=self.text, cnts=self.cnts, aux=self.aux,
                 poslist=self.poslist, cmax=np.int32(self.cmax),
                 heavy_rate=np.float64(self.heavy_rate),
                 right_sorted=np.bool_(self.right_sorted),
                 k=np.int32(self.k), j0=np.int32(self.j0),
                 level_js=np.asarray(sorted(self.levels), dtype=np.int32),
                 **{f"level_{j}": bm for j, bm in self.levels.items()},
                 **extra)

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "AnchorIndexWide":
        z = np.load(path, mmap_mode="r" if mmap else None)
        levels = {int(j): np.asarray(z[f"level_{int(j)}"])
                  for j in z["level_js"]}
        opt = {name: np.asarray(z[name]) for name in
               ("leftidx", "heavy_keys", "heavy_offs", "heavy_poslist",
                "heavy_leftperm")
               if name in z.files}
        return cls(text=np.asarray(z["text"]), k=int(z["k"]),
                   j0=int(z["j0"]), cnts=np.asarray(z["cnts"]),
                   aux=np.asarray(z["aux"]),
                   poslist=np.asarray(z["poslist"]), levels=levels,
                   cmax=int(z["cmax"]),
                   heavy_rate=float(z["heavy_rate"])
                   if "heavy_rate" in z.files else -1.0,
                   right_sorted=bool(z["right_sorted"])
                   if "right_sorted" in z.files else False, **opt)


def _keys_and_clean(text: np.ndarray, k: int,
                    block: int = 1 << 27
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """keys[p] = base-4 value of the k symbols ending at p (digit i =
    symbol p-i; junk digits where symbols are non-ACGT), cleanc[p] =
    ACGT run length ending at p (saturated at 255). Chunked so peak
    memory beyond the two outputs stays ~2 B/symbol."""
    n = len(text)
    keys = np.zeros(n, dtype=np.int32)
    cleanc = np.zeros(n, dtype=np.uint8)
    carry = 0                       # clean-run length ending at lo-1
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        s = max(0, lo - (k - 1))    # overlap completes every window
        t = (text[s:hi].astype(np.int32) - 1) & 3
        m = len(t)
        acc = np.zeros(m, dtype=np.int32)
        for i in range(k):
            sh = np.zeros(m, dtype=np.int32)
            sh[i:] = t[: max(0, m - i)]
            acc += sh << (2 * i)
        keys[lo:hi] = acc[lo - s:]
        del acc, t
        bad = (text[lo:hi] < 1) | (text[lo:hi] > 4)
        idx = np.arange(hi - lo, dtype=np.int64)
        lb = np.maximum.accumulate(np.where(bad, idx, -1))
        run = np.where(lb >= 0, idx - lb, idx + 1 + carry)
        cleanc[lo:hi] = np.minimum(run, 255).astype(np.uint8)
        carry = int(min(run[-1], 255)) if hi > lo else carry
    return keys, cleanc


def pick_k_wide(n: int) -> int:
    """Anchor k-mer size for a forward text of n symbols: ~log4(2n)
    keeps per-anchor occurrence counts low while the direct tables stay
    a few bytes per symbol (capped at WIDE_K — 4^k rows of meta)."""
    k = 8
    while 4 ** k < 2 * n and k < WIDE_K:
        k += 1
    return k


def _native_wide():
    """The widebuild.cpp entry points, or None (pure-numpy fallback)."""
    try:
        from ..io.native import load
        lib = load()
    except Exception:
        return None
    if lib is None or not hasattr(lib, "svdss_wide_keys"):
        return None
    return lib


def _bucket_order(Tc: np.ndarray, first: np.ndarray, step: int,
                  W: int = 32) -> np.ndarray:
    """Exact lexicographic order of text runs for one bucket.

    Run i reads comparator symbols Tc[first[i]], Tc[first[i]+step], ...
    until the text boundary; out-of-text compares SMALLER than any
    symbol (suffix-array sentinel convention). Returns the member
    indices in ascending order. Window-refined lexsort: ties within a
    W-symbol window recurse W deeper (two distinct positions can never
    be fully equal to the boundary, so recursion terminates)."""
    n = len(Tc)
    c = len(first)
    out = np.empty(c, dtype=np.int64)
    if c <= 1:
        out[:c] = 0
        return out
    first = first.astype(np.int64)
    stack = [(0, np.arange(c, dtype=np.int64), 0)]
    while stack:
        base, mem, d = stack.pop()
        p = first[mem][:, None] + step * (d + np.arange(W))[None, :]
        valid = (p >= 0) & (p < n)
        sym = np.where(valid, Tc[np.clip(p, 0, n - 1)].astype(np.int16),
                       np.int16(-1))
        o = np.lexsort(tuple(sym[:, w] for w in range(W - 1, -1, -1)))
        sym_o, mem_o = sym[o], mem[o]
        eq = np.all(sym_o[1:] == sym_o[:-1], axis=1)
        gb = np.flatnonzero(np.concatenate([[True], ~eq]))
        gb = np.append(gb, len(mem_o))
        cur = base
        for gi in range(len(gb) - 1):
            a, b = int(gb[gi]), int(gb[gi + 1])
            if b - a == 1:
                out[cur] = mem_o[a]
            elif np.all(sym_o[a] == -1):
                # fully exhausted tie (unreachable for distinct
                # positions; positional order keeps determinism)
                out[cur:cur + (b - a)] = np.sort(mem_o[a:b])
            else:
                stack.append((cur, mem_o[a:b], d + W))
            cur += b - a
    return out


def _sort_buckets_numpy(text: np.ndarray, k: int, aux: np.ndarray,
                        cnts_full: np.ndarray, keep: np.ndarray,
                        poslist: np.ndarray,
                        emit_left: bool = True) -> Optional[np.ndarray]:
    """Reorder every kept bucket of `poslist` into right-suffix order
    (in place) and return the left-order inverse permutation
    (`leftidx`, int64 — the caller narrows to the artifact dtype), or
    None when emit_left=False (right-order-only tables).
    Pure-numpy fallback for the native sort pass."""
    Tc = ((text.astype(np.int16) - 1) & 3).astype(np.uint8)
    leftidx = np.zeros(len(poslist), dtype=np.int64) if emit_left else None
    for key in np.flatnonzero(keep):
        off = int(aux[key])
        c = int(cnts_full[key])
        sl = poslist[off:off + c].astype(np.int64)
        ro = _bucket_order(Tc, sl + k, +1)
        sl = sl[ro]
        poslist[off:off + c] = sl.astype(np.uint32)
        if emit_left:
            lo = _bucket_order(Tc, sl - 1, -1)
            leftidx[off:off + c] = lo
    return leftidx


def build_anchor_index_wide(text: np.ndarray, k: Optional[int] = None,
                            cmax: int = WIDE_CMAX,
                            log: Optional[Callable[[str], None]] = None,
                            block: int = 1 << 27,
                            use_native: bool = True,
                            sort_buckets: "bool | str" = True,
                            keep_heavy: bool = True) -> AnchorIndexWide:
    """Build wide tables over a FORWARD text (n < 2^32).

    The keys/count/scatter/sort passes run in native C++ when
    native/libsvdss_native.so is built (bit-identical, ~20x faster at
    GRCh38 scale — the numpy keys pass alone is ~25 min at 3.1G
    symbols); peak host memory ~20 B/symbol either way.

    sort_buckets orders each kept bucket by the following suffix and
    emits the leftidx permutation (the device binary-probe engine's
    table format); sort_buckets="right" sorts but omits leftidx (the
    GRCh38-fit format: ~1 B/entry less HBM, orientation B scans
    linearly); keep_heavy retains pruned occurrence lists in the
    host-only heavy store (the per-phase resolver's data). Both default
    on; legacy (unsorted, no-store) artifacts still load and search.
    """
    def say(msg):
        if log:
            log(msg)

    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    assert n < 2 ** 32, "wide anchor coordinates are uint32"
    if k is None:
        k = pick_k_wide(n)
    # int32 keys host+native; native widebuild.cpp's (1u << 2k) - 1
    # mask is UB at k >= 16, so reject explicit k past the key width
    # even though pick_k_wide caps at 14
    assert 1 <= k <= 15, f"wide anchor k={k} exceeds int32 key range"
    # saturation argument: cnts saturate at their dtype max > cmax, so
    # a saturated strand count alone already reads heavy, and
    # unsaturated totals are exact — cmax <= dtype_max - 1 keeps the
    # device's heavy test exact. leftidx (bucket-local index) is uint8
    # for cmax <= 254, uint16 up to 65534 (the deep-residency builds:
    # dispersed-repeat families stay device-resident behind the
    # O(log cnt) binary probes; only satellite-core k-mers park).
    assert 2 <= cmax <= 65534, f"wide cmax={cmax} outside [2, 65534]"
    cdtype = np.uint8 if cmax <= 254 else np.uint16
    csat = 255 if cmax <= 254 else 65535
    ldtype = np.uint8 if cmax <= 254 else np.uint16
    nk = 1 << (2 * k)
    lib = _native_wide() if use_native else None

    if lib is not None:
        keys = np.empty(n, dtype=np.int32)
        cleanc = np.empty(n, dtype=np.uint8)
        lib.svdss_wide_keys(text.ctypes.data, n, k,
                            keys.ctypes.data, cleanc.ctypes.data)
    else:
        keys, cleanc = _keys_and_clean(text, k, block)
    say("keys built")

    # counts
    if lib is not None:
        cnts_full = np.zeros(nk, dtype=np.int64)
        lib.svdss_wide_count(keys.ctypes.data, cleanc.ctypes.data, n, k,
                             cnts_full.ctypes.data)
    else:
        cnts_full = np.zeros(nk + 1, dtype=np.int64)
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            kb = np.where(cleanc[lo:hi] >= min(k, 255), keys[lo:hi], nk)
            cnts_full += np.bincount(kb, minlength=nk + 1)
        cnts_full = cnts_full[:nk]
    say(f"{int(cnts_full.sum())} valid windows, "
        f"{int((cnts_full > 0).sum())} distinct k-mers")

    # two-strand presence bitmaps (chunked)
    levels = {}
    j0 = k - 1
    for j in range(k - 1, 0, -1):
        present = np.zeros(1 << (2 * j), dtype=bool)
        mj = np.int32((1 << (2 * j)) - 1)
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            sel = cleanc[lo:hi] >= j
            present[(keys[lo:hi] & mj)[sel]] = True
        present |= present[rc_keys(np.arange(1 << (2 * j),
                                             dtype=np.int64), j)]
        if present.all():
            j0 = j
            break
        bm = np.zeros(((1 << (2 * j)) + 31) // 32, dtype=np.uint32)
        idx = np.nonzero(present)[0]
        np.bitwise_or.at(bm, idx >> 5, np.uint32(1) << (idx & 31))
        levels[j] = bm
        j0 = j - 1
    say(f"levels built, j0={j0}")

    # prune: keep positions only for k-mers whose TWO-STRAND count is in
    # [2, cmax]; two-strand count = cnt[key] + cnt[rc(key)]
    rck = rc_keys(np.arange(nk, dtype=np.int64), k)
    total = cnts_full + cnts_full[rck]
    keep = (total <= cmax) & (cnts_full >= 2)
    # position-weighted phase-heavy rate: the probability a uniformly
    # placed anchor phase lands on an over-cmax k-mer (= the device
    # fallback driver on repeat-rich genomes; stored so engine
    # auto-selection can see the genome's repeat profile)
    heavy_rate = float(cnts_full[total > cmax].sum()
                       / max(1, cnts_full.sum()))
    say(f"heavy (two-strand > {cmax}): {int((total > cmax).sum())} "
        f"k-mers, {int(cnts_full[total > cmax].sum())} positions pruned "
        f"(phase-heavy rate {heavy_rate:.2%})")

    # aux: inline position for singletons, poslist offset for kept
    # multis, sentinel for pruned/heavy
    aux = np.full(nk, 0xFFFFFFFF, dtype=np.uint32)
    seg = np.zeros(nk + 1, dtype=np.int64)
    np.cumsum(np.where(keep, cnts_full, 0), out=seg[1:])
    np_total = int(seg[-1])
    assert np_total < 2 ** 32, "poslist offsets are uint32"
    aux[keep] = seg[:-1][keep].astype(np.uint32)

    single = cnts_full == 1
    heavy = keep_heavy and ((cnts_full >= 2) & (total > cmax))
    if keep_heavy:
        hseg = np.zeros(nk + 1, dtype=np.int64)
        np.cumsum(np.where(heavy, cnts_full, 0), out=hseg[1:])
        nh_total = int(hseg[-1])
    else:
        nh_total = 0
    if lib is not None:
        # counting-sort scatter: per key, positions ascending — the
        # same grouped order the stable argsort below produces
        cursor = seg[:-1].copy()
        poslist = np.empty(np_total, dtype=np.uint32)
        keep_u8 = keep.astype(np.uint8)
        single_u8 = single.astype(np.uint8)
        written = lib.svdss_wide_scatter(
            keys.ctypes.data, cleanc.ctypes.data, n, k,
            keep_u8.ctypes.data, cursor.ctypes.data,
            poslist.ctypes.data, single_u8.ctypes.data, aux.ctypes.data)
        assert written == np_total, "kept-entry count mismatch"
        del cursor, keep_u8, single_u8
        if nh_total:
            hcursor = hseg[:-1].copy()
            heavy_poslist = np.empty(nh_total, dtype=np.uint32)
            heavy_u8 = heavy.astype(np.uint8)
            none_u8 = np.zeros(nk, dtype=np.uint8)
            hw = lib.svdss_wide_scatter(
                keys.ctypes.data, cleanc.ctypes.data, n, k,
                heavy_u8.ctypes.data, hcursor.ctypes.data,
                heavy_poslist.ctypes.data, none_u8.ctypes.data,
                aux.ctypes.data)
            assert hw == nh_total, "heavy-entry count mismatch"
            del hcursor, heavy_u8, none_u8
        del keys, cleanc
    else:
        # gather the kept entries (chunked), then one stable argsort
        # groups positions by key; singleton inline positions fill in
        # the same pass
        def _gather(sel_mask, count):
            vk = np.empty(count, dtype=np.int32)
            st = np.empty(count, dtype=np.uint32)
            w = 0
            for lo in range(0, n, block):
                hi = min(n, lo + block)
                kb = keys[lo:hi]
                okb = cleanc[lo:hi] >= min(k, 255)
                starts_b = (np.arange(lo, hi, dtype=np.int64) - (k - 1))
                ke = okb & sel_mask[kb]
                m = int(ke.sum())
                vk[w:w + m] = kb[ke]
                st[w:w + m] = starts_b[ke].astype(np.uint32)
                w += m
            assert w == count, "entry count mismatch"
            order = np.argsort(vk, kind="stable")
            return np.ascontiguousarray(st[order])

        for lo in range(0, n, block):
            hi = min(n, lo + block)
            kb = keys[lo:hi]
            okb = cleanc[lo:hi] >= min(k, 255)
            starts_b = (np.arange(lo, hi, dtype=np.int64) - (k - 1))
            se = okb & single[kb]
            aux[kb[se]] = starts_b[se].astype(np.uint32)
        poslist = _gather(keep, np_total)
        heavy_poslist = _gather(heavy, nh_total) if nh_total else None
        del keys, cleanc
    say(f"poslist {np_total} entries"
        + (f", heavy store {nh_total} entries" if nh_total else ""))

    heavy_keys = heavy_offs = None
    if nh_total:
        heavy_keys = np.flatnonzero(heavy).astype(np.int64)
        heavy_offs = np.zeros(len(heavy_keys) + 1, dtype=np.int64)
        np.cumsum(cnts_full[heavy_keys], out=heavy_offs[1:])
    elif keep_heavy:
        heavy_keys = np.zeros(0, dtype=np.int64)
        heavy_offs = np.zeros(1, dtype=np.int64)
        heavy_poslist = np.zeros(0, dtype=np.uint32)
    else:
        heavy_poslist = None

    leftidx = None
    heavy_leftperm = None
    right_only = sort_buckets == "right"
    if sort_buckets and right_only:
        # GRCh38-fit format: right-suffix bucket order, no leftidx
        # (orientation-A binary probes only; B scans linearly on device)
        if lib is not None and hasattr(lib, "svdss_wide_sort_right"):
            keep_u8 = keep.astype(np.uint8)
            lib.svdss_wide_sort_right(
                text.ctypes.data, n, k, aux.ctypes.data,
                cnts_full.ctypes.data, keep_u8.ctypes.data,
                poslist.ctypes.data, 2)
            del keep_u8
        else:
            _sort_buckets_numpy(text, k, aux, cnts_full, keep, poslist,
                                emit_left=False)
        say("buckets sorted (right order only)")
    elif sort_buckets:
        native_sort = "svdss_wide_sort" if ldtype == np.uint8 \
            else "svdss_wide_sort16"
        if lib is not None and hasattr(lib, native_sort):
            leftidx = np.zeros(np_total, dtype=ldtype)
            keep_u8 = keep.astype(np.uint8)
            cfs = np.minimum(cnts_full, csat).astype(cdtype)
            getattr(lib, native_sort)(
                text.ctypes.data, n, k, aux.ctypes.data,
                cfs.ctypes.data, keep_u8.ctypes.data,
                poslist.ctypes.data, leftidx.ctypes.data, 2)
            del keep_u8, cfs
        else:
            leftidx = _sort_buckets_numpy(text, k, aux, cnts_full, keep,
                                          poslist).astype(ldtype)
        say("buckets sorted (right order + leftidx)")
        if nh_total:
            # heavy buckets sort by RAW nt6 bytes (the host resolver's
            # binary search must agree with the oracle's N-matching
            # semantics; the device buckets' 2-bit class order is safe
            # only because device probes touching non-ACGT rows fall
            # back — the host resolver has no such escape)
            heavy_leftperm = np.zeros(nh_total, dtype=np.uint32)
            if lib is not None and hasattr(lib, "svdss_wide_sort_heavy"):
                lib.svdss_wide_sort_heavy(
                    text.ctypes.data, n, k, heavy_keys.ctypes.data,
                    heavy_offs.ctypes.data, len(heavy_keys),
                    heavy_poslist.ctypes.data,
                    heavy_leftperm.ctypes.data, 2)
            else:
                for hi_ in range(len(heavy_keys)):
                    o0 = int(heavy_offs[hi_])
                    o1 = int(heavy_offs[hi_ + 1])
                    sl = heavy_poslist[o0:o1].astype(np.int64)
                    ro = _bucket_order(text, sl + k, +1)
                    sl = sl[ro]
                    heavy_poslist[o0:o1] = sl.astype(np.uint32)
                    lo_ = _bucket_order(text, sl - 1, -1)
                    heavy_leftperm[o0:o1] = lo_.astype(np.uint32)
            say("heavy store sorted (raw-byte order)")
        elif keep_heavy:
            heavy_leftperm = np.zeros(0, dtype=np.uint32)

    cnts = np.minimum(cnts_full, csat).astype(cdtype)
    return AnchorIndexWide(text=text, k=k, j0=j0, cnts=cnts, aux=aux,
                           poslist=poslist, levels=levels, cmax=cmax,
                           heavy_rate=heavy_rate, leftidx=leftidx,
                           heavy_keys=heavy_keys, heavy_offs=heavy_offs,
                           heavy_poslist=heavy_poslist,
                           heavy_leftperm=heavy_leftperm,
                           right_sorted=right_only)


# ------------------------------------------------------------- host search

def _clean_run(P, p, need):
    run = 0
    while run < need and p - run >= 0 and 1 <= P[p - run] <= 4:
        run += 1
    return run


def _key_ending(P, p, j):
    key = 0
    for i in range(j):
        key += (int(P[p - i]) - 1) * (4 ** i)
    return key


# A heavy-phase resolver: (P, pos, direction) -> matching statistic m.
# direction "left": max m with P[pos-m+1..pos] in the two-strand set;
# "right": max m with P[pos..pos+m-1] in it. Used in place of
# NeedsFallback when provided (the exact FM engine supplies it).
Resolver = Callable[[np.ndarray, int, str], int]


def _max_ext_vec(T: np.ndarray, occ: np.ndarray, Pw: np.ndarray,
                 cap: int, step: int, t0_off: int) -> int:
    """max extension over occurrence array `occ` against the pattern
    window `Pw` (already orientation-transformed, Pw[e] is the symbol
    the text must equal at extension e; Pw[e] < 0 marks a never-match
    read symbol). Text position for occurrence p at extension e is
    p + t0_off + step*e. Vectorized with survivor compaction — heavy
    buckets run to millions of entries."""
    n = len(T)
    if cap <= 0 or len(occ) == 0:
        return 0
    alive = occ.astype(np.int64)
    best = 0
    e = 0
    CH = 16
    while len(alive) and e < cap:
        w = min(CH, cap - e)
        p = alive[:, None] + t0_off + step * (e + np.arange(w))[None, :]
        inb = (p >= 0) & (p < n)
        tv = np.where(inb, T[np.clip(p, 0, n - 1)].astype(np.int16), -1)
        pv = Pw[e:e + w][None, :]
        ok = inb & (tv == pv) & (pv >= 0)
        run = np.where(ok.all(axis=1), w,
                       np.argmin(ok, axis=1))
        m = int(run.max(initial=0))
        best = max(best, e + m)
        if best >= cap:
            return cap
        alive = alive[run == w]
        e += w
    return best


def _bin_max_ext(T: np.ndarray, bucket: np.ndarray,
                 perm: Optional[np.ndarray], Pw: np.ndarray, cap: int,
                 step: int, t0_off: int) -> int:
    """Max extension over a RAW-byte-ordered heavy bucket by binary
    search (suffix-array insertion argument: the probe path's max LCP
    with the query is the bucket max). bucket is right-ordered; pass
    perm (the left-order inverse permutation) for leftward extensions.
    Exactness relies on the order's comparator being raw equality —
    the same predicate as the oracle's match rules, N included."""
    n = len(T)
    c = len(bucket)
    if cap <= 0 or c == 0:
        return 0
    bad = np.flatnonzero(Pw[:cap] < 0)
    ecut = int(bad[0]) if len(bad) else cap
    if ecut == 0:
        return 0
    Pq = Pw[:ecut].astype(np.int16)
    lo, hi = 0, c
    best = 0
    CH = 64
    while lo < hi:
        mid = (lo + hi) >> 1
        i = int(perm[mid]) if perm is not None else mid
        p = int(bucket[i])
        d = 0
        lt = True
        while True:
            w = min(CH, ecut - d)
            if w <= 0:
                d = ecut          # query exhausted: full-length match
                break
            ps = p + t0_off + step * d
            if step > 0:
                seg = T[ps:ps + w] if 0 <= ps < n else T[:0]
            else:
                seg = (T[max(ps - (w - 1), 0):ps + 1][::-1]
                       if ps >= 0 else T[:0])
            m = len(seg)
            q = Pq[d:d + m]
            neq = np.flatnonzero(seg != q)
            if len(neq):
                j = int(neq[0])
                d += j
                lt = bool(int(seg[j]) < int(q[j]))
                break
            d += m
            if m < w:             # text boundary: run sorts smaller
                lt = True
                break
        best = max(best, d)
        if best >= ecut:
            return min(best, cap)
        if lt:
            lo = mid + 1
        else:
            hi = mid
    return min(best, cap)


def make_heavy_resolver(idx: AnchorIndexWide) -> Optional[Resolver]:
    """Exact heavy-phase resolver backed by the host-only heavy store —
    the per-phase answer for k-mers pruned from the device poslist
    (no FM index required). Returns None on legacy artifacts without
    the store. Semantics match ms_left_wide / fms_right_wide's
    extension loops symbol for symbol. Heavy buckets resolve by binary
    search over the store's raw-byte order when present (O(log cnt)
    text compares — satellite mega-buckets answer in microseconds);
    linear vectorized scan otherwise."""
    if idx.heavy_keys is None:
        return None
    T = idx.text
    k = idx.k

    def side_ext(key: int, Pw: np.ndarray, cap: int, step: int,
                 t0_off: int) -> int:
        c = int(idx.cnts[key])
        if c == 0 or cap <= 0:
            return 0
        if c == 1:
            return _max_ext_vec(T, np.array([idx.aux[key]],
                                            dtype=np.uint32),
                                Pw, cap, step, t0_off)
        off = int(idx.aux[key])
        if off != 0xFFFFFFFF:      # kept bucket (<= cmax): linear scan
            return _max_ext_vec(T, idx.poslist[off:off + c], Pw, cap,
                                step, t0_off)
        hi_ = int(np.searchsorted(idx.heavy_keys, key))
        if hi_ >= len(idx.heavy_keys) or \
                int(idx.heavy_keys[hi_]) != key:
            return 0
        o0 = int(idx.heavy_offs[hi_])
        o1 = int(idx.heavy_offs[hi_ + 1])
        bucket = idx.heavy_poslist[o0:o1]
        if idx.heavy_leftperm is None:
            return _max_ext_vec(T, bucket, Pw, cap, step, t0_off)
        perm = idx.heavy_leftperm[o0:o1] if step < 0 else None
        return _bin_max_ext(T, bucket, perm, Pw, cap, step, t0_off)

    def resolver(P: np.ndarray, pos: int, direction: str) -> int:
        P = np.asarray(P, dtype=np.uint8)
        Pi = P.astype(np.int16)
        if direction == "left":
            r = pos
            maxlen = r + 1
            key = _key_ending(P, r, k)
            cap = maxlen - k
            # orientation A: forward occurrence, extend LEFT;
            # Pw[e] = P[r-k-e] (match requires P != 0)
            wa = Pi[r - k::-1][:cap] if r - k >= 0 else Pi[:0]
            wa = np.where(wa == 0, -1, wa)
            # orientation B: occurrence of RC key, extend RIGHT with
            # complemented read symbols (match requires 1<=P<=4)
            wb = 5 - Pi[r - k::-1][:cap] if r - k >= 0 else Pi[:0]
            wb = np.where((wb >= 1) & (wb <= 4), wb, -1)
            best = side_ext(key, wa, cap, -1, -1)
            if best < cap:
                rkey = rc_key_scalar(key, k)
                best = max(best, side_ext(rkey, wb, cap, +1, k))
            return k + best
        b = pos
        l = len(P)
        maxlen = l - b
        key = _key_ending(P, b + k - 1, k)
        cap = maxlen - k
        wa = Pi[b + k:b + k + cap]
        wa = np.where(wa == 0, -1, wa)
        wb = 5 - Pi[b + k:b + k + cap]
        wb = np.where((wb >= 1) & (wb <= 4), wb, -1)
        best = side_ext(key, wa, cap, +1, k)
        if best < cap:
            rkey = rc_key_scalar(key, k)
            best = max(best, side_ext(rkey, wb, cap, -1, -1))
        return k + best

    return resolver


def ms_left_wide(idx: AnchorIndexWide, P: np.ndarray, r: int,
                 resolver: Optional[Resolver] = None) -> int:
    """max m such that P[r-m+1..r] occurs on either strand (m <= r+1).

    Bit-identical to ops/anchor.py ms_left over the two-strand text.
    """
    T = idx.text
    k, j0 = idx.k, idx.j0
    maxlen = r + 1
    if maxlen <= j0:
        if _clean_run(P, r, maxlen) < maxlen:
            raise NeedsFallback
        return maxlen
    if _clean_run(P, r, min(k, maxlen)) < min(k, maxlen):
        raise NeedsFallback
    if maxlen >= k:
        key = _key_ending(P, r, k)
        rkey = rc_key_scalar(key, idx.k)
        ctot = int(idx.cnts[key]) + int(idx.cnts[rkey])
        if ctot == 0:
            for j in range(k - 1, j0, -1):
                if idx.level_present(j, _key_ending(P, r, j) % (4 ** j)):
                    return j
            return j0
        if ctot > idx.cmax:
            if resolver is not None:
                return resolver(P, r, "left")
            raise NeedsFallback
        cap = maxlen - k
        # orientation A: forward occurrence of the k-mer, extend LEFT
        # (vectorized; Pw[e] = P[r-k-e], symbol 0 never matches —
        # element-for-element the scalar loops this replaces)
        Pi = P.astype(np.int16)
        wa = Pi[r - k::-1][:cap] if r - k >= 0 else Pi[:0]
        wa = np.where(wa == 0, -1, wa)
        best = _max_ext_vec(T, idx.occurrences(key), wa, cap, -1, -1)
        if best < cap:
            # orientation B: forward occurrence of the RC k-mer, extend
            # RIGHT comparing complemented read symbols
            wb = 5 - Pi[r - k::-1][:cap] if r - k >= 0 else Pi[:0]
            wb = np.where((wb >= 1) & (wb <= 4), wb, -1)
            best = max(best, _max_ext_vec(T, idx.occurrences(rkey), wb,
                                          cap, +1, k))
        return k + best
    for j in range(maxlen, j0, -1):
        if idx.level_present(j, _key_ending(P, r, j)):
            return j
    return j0


def fms_right_wide(idx: AnchorIndexWide, P: np.ndarray, l: int, b: int,
                   resolver: Optional[Resolver] = None) -> int:
    """max m such that P[b..b+m-1] occurs on either strand (m <= l-b)."""
    T = idx.text
    k, j0 = idx.k, idx.j0
    maxlen = l - b
    if maxlen <= j0:
        if _clean_run(P, b + maxlen - 1, maxlen) < maxlen:
            raise NeedsFallback
        return maxlen
    if _clean_run(P, b + min(k, maxlen) - 1, min(k, maxlen)) \
            < min(k, maxlen):
        raise NeedsFallback
    if maxlen >= k:
        key = _key_ending(P, b + k - 1, k)
        rkey = rc_key_scalar(key, idx.k)
        ctot = int(idx.cnts[key]) + int(idx.cnts[rkey])
        if ctot == 0:
            for j in range(k - 1, j0, -1):
                if idx.level_present(j, _key_ending(P, b + j - 1, j)):
                    return j
            return j0
        if ctot > idx.cmax:
            if resolver is not None:
                return resolver(P, b, "right")
            raise NeedsFallback
        cap = maxlen - k
        # orientation A: forward occurrence, extend RIGHT (vectorized)
        Pi = P.astype(np.int16)
        wa = Pi[b + k:b + k + cap]
        wa = np.where(wa == 0, -1, wa)
        best = _max_ext_vec(T, idx.occurrences(key), wa, cap, +1, k)
        if best < cap:
            # orientation B: forward occurrence of the RC k-mer, extend
            # LEFT comparing complemented read symbols
            wb = 5 - Pi[b + k:b + k + cap]
            wb = np.where((wb >= 1) & (wb <= 4), wb, -1)
            best = max(best, _max_ext_vec(T, idx.occurrences(rkey), wb,
                                          cap, -1, -1))
        return k + best
    for j in range(maxlen, j0, -1):
        if idx.level_present(j, _key_ending(P, b + j - 1, j)):
            return j
    return j0


def anchor_search_wide(idx: AnchorIndexWide, P: np.ndarray,
                       overlap: int = -1,
                       resolver: Optional[Resolver] = None
                       ) -> List[Tuple[int, int]]:
    """SFS (query_start, length) pairs for one nt6 read — identical
    output to the narrow anchor oracle and the FM ping-pong over the
    two-strand text. Raises NeedsFallback for reads the wide path
    cannot resolve exactly (unless a heavy-anchor resolver is given)."""
    P = np.asarray(P, dtype=np.uint8)
    l = int(len(P))
    out: List[Tuple[int, int]] = []
    if l == 0:
        return out
    begin = l - 1
    while begin >= 0:
        m = ms_left_wide(idx, P, begin, resolver)
        if m == begin + 1:
            break
        b = begin - m
        fm = fms_right_wide(idx, P, l, b, resolver)
        end = b + fm
        out.append((b, end - b + 1))
        if b == 0:
            break
        begin = end + overlap if overlap != 0 else b - 1
    return out
