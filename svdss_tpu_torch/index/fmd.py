"""FMD index: bidirectional FM-index over both genome strands, flat layout.

Replaces ropebwt3's run-length-encoded rope BWT (reference
ping_pong.cpp:244-245 restores it; rb3_fmd_set_intv / rb3_fmd_extend drive
the search) with a *flat array* layout designed for TPU HBM:

  * ``bwt_words`` int32[nblk, 16] — BWT symbols packed 4 bits each, 128
    symbols per 64-byte block row;
  * ``occ``       int32[nblk, 8] — per-block checkpoint: count of each nt6
    symbol in BWT[0 : 128*b] (2 pad lanes);
  * ``C``         int64[8]      — cumulative symbol counts over the text.

rank(c, p) = occ[p//128, c] + popcount of c among the first p%128 symbols of
block p//128 — one 64B block row + one 32B occ row per query, friendly to
both vectorized host numpy and device gathers.

Text layout: for each chromosome S, append nt6(S), $, nt6(revcomp(S)), $.
Closure under reverse complement gives the FMD property; sentinels are real
symbols so no bwa-style "primary" correction is needed.

Extension semantics match rb3_fmd_extend exactly: child interval of symbol c
gets x[rank side] = C[c] + rank_c(lo), size = rank_c(hi) - rank_c(lo), and
the opposite coordinate is assigned cumulatively over symbols in the order
$, T, G, C, A, N (complement-sorted), cf. SURVEY.md §3.3.

$-ordering note: our suffix array breaks sentinel ties by suffix content
rather than by ropebwt3's string order. Every rank position the search can
query is >= C[1] (= #sentinels), and symbol counts over prefixes that
contain the whole $-block are invariant to its internal order, so ping-pong
search results are identical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..utils.seq import COMP6, encode_nt6, revcomp_nt6
from .suffix_array import suffix_array

BLOCK = 128            # symbols per occ checkpoint block
WORDS = BLOCK // 8     # int32 words per block (4-bit packed)


@dataclasses.dataclass
class BiInterval:
    """FMD bi-interval: x0 = SA range start of W, x1 = of revcomp(W), size."""
    x0: int
    x1: int
    size: int


def _occ_checkpoints(bwt: np.ndarray, nblk: int, block: int,
                     chunk_blocks: int = 1 << 17) -> np.ndarray:
    """Per-block symbol-count checkpoints, O(chunk) extra memory.

    int32 while counts fit (halves memory for sub-2^31 indexes), int64
    past that (whole-genome scale)."""
    n = len(bwt)
    per_block = np.zeros((nblk, 8), dtype=np.int64)
    padded = np.zeros(nblk * block, dtype=np.uint8)
    padded[:n] = bwt
    for start in range(0, nblk, chunk_blocks):
        stop = min(start + chunk_blocks, nblk)
        seg = padded[start * block:stop * block].reshape(-1, block)
        for c in range(6):
            per_block[start:stop, c] = (seg == c).sum(axis=1)
    if n < nblk * block:
        # padding zeros were counted as symbol 0 in the final block
        per_block[-1, 0] -= nblk * block - n
    occ = np.zeros((nblk, 8), dtype=np.int64)
    occ[1:] = np.cumsum(per_block, axis=0)[:-1]
    if occ.max() < 2**31:
        return occ.astype(np.int32)
    return occ


def _pack_nibbles(bwt: np.ndarray, nblk: int,
                  chunk_blocks: int = 1 << 17) -> np.ndarray:
    """4-bit-pack the BWT, chunked (the uint32 staging is 4 bytes/symbol)."""
    out = np.empty((nblk, WORDS), dtype=np.int32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    n = len(bwt)
    for s in range(0, nblk, chunk_blocks):
        e = min(s + chunk_blocks, nblk)
        seg = np.zeros((e - s) * BLOCK, dtype=np.uint32)
        lo, hi = s * BLOCK, min(n, e * BLOCK)
        if hi > lo:
            seg[: hi - lo] = bwt[lo:hi]
        seg = seg.reshape(e - s, BLOCK // 8, 8)
        words = (seg << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
        out[s:e] = words.astype(np.int32)  # bit-identical reinterpret
    return out


class FMDIndex:
    """Flat FMD index. Stores only the packed BWT + occ checkpoints + C —
    no raw byte-per-symbol copy (at whole-genome scale that alone is
    ~6.2 GB); `bwt_symbols()` unpacks on demand in chunks."""

    def __init__(self, bwt: np.ndarray, counts: np.ndarray):
        assert bwt.dtype == np.uint8
        self.n = int(len(bwt))
        # C[c] = number of symbols < c in the text (acc[] in rb3)
        self.C = np.zeros(8, dtype=np.int64)
        self.C[1:7] = np.cumsum(counts[:6])
        self.C[7] = self.C[6]
        nblk = self.n // BLOCK + 1
        self.nblk = nblk
        # occ[b, c] = count of symbol c in BWT[0 : 128*b], computed in
        # bounded-memory chunks (a full one-hot would be ~32 bytes/symbol)
        self.occ = _occ_checkpoints(bwt, nblk, BLOCK)
        self.bwt_words = _pack_nibbles(bwt, nblk)

    @classmethod
    def from_parts(cls, n: int, C: np.ndarray, occ: np.ndarray,
                   bwt_words: np.ndarray) -> "FMDIndex":
        """Rebuild from persisted arrays without re-deriving checkpoints."""
        self = cls.__new__(cls)
        self.n = int(n)
        self.C = C.astype(np.int64)
        self.nblk = self.n // BLOCK + 1
        self.occ = occ
        self.bwt_words = bwt_words
        return self

    def bwt_symbols(self) -> np.ndarray:
        """The BWT as one uint8 symbol per element (unpacked in chunks —
        the result is n bytes, the transient overhead is bounded)."""
        out = np.empty(self.nblk * BLOCK, dtype=np.uint8)
        shifts = np.arange(8, dtype=np.uint32) * 4
        chunk = 1 << 20
        for s in range(0, self.nblk, chunk):
            e = min(s + chunk, self.nblk)
            words = self.bwt_words[s:e].view(np.uint32)
            nibs = ((words[:, :, None] >> shifts) & np.uint32(0xF))
            out[s * BLOCK:e * BLOCK] = nibs.astype(np.uint8).reshape(-1)
        return out[: self.n]

    # -- construction ------------------------------------------------------

    @classmethod
    def from_text(cls, text: np.ndarray) -> "FMDIndex":
        sa = suffix_array(text)
        bwt = text[(sa - 1) % len(text)]
        counts = np.bincount(text, minlength=8)
        return cls(bwt.astype(np.uint8), counts)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist bwt_words + occ + C (uncompressed npz: load is one
        sequential read with no checkpoint re-derivation — the reference
        reuses its .fmd across samples the same way, README.md:104)."""
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 n=np.int64(self.n), C=self.C, occ=self.occ,
                 bwt_words=self.bwt_words)

    @classmethod
    def load(cls, path: str) -> "FMDIndex":
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        if "bwt_words" in data.files:
            return cls.from_parts(int(data["n"]), data["C"], data["occ"],
                                  data["bwt_words"])
        # v1 format (raw BWT only): re-derive checkpoints
        bwt = data["bwt"]
        counts = np.bincount(bwt, minlength=8)
        return cls(bwt, counts)

    # -- host-side queries (numpy; the device path is ops/fmd_jax.py) ------

    def rank6(self, pos) -> np.ndarray:
        """Counts of symbols 0..5 in BWT[0:pos]; pos may be an array.

        Returns shape pos.shape + (6,).
        """
        pos = np.asarray(pos, dtype=np.int64)
        blk = pos // BLOCK
        off = pos % BLOCK
        base = self.occ[blk][..., :6].astype(np.int64)
        words = self.bwt_words[blk].view(np.uint32)       # [..., 16]
        shifts = (np.arange(8, dtype=np.uint32) * 4)
        nibs = (words[..., :, None] >> shifts) & np.uint32(0xF)
        nibs = nibs.reshape(pos.shape + (BLOCK,))
        in_range = np.arange(BLOCK) < off[..., None]
        eq = nibs[..., None] == np.arange(6, dtype=np.uint32)
        cnt = (eq & in_range[..., None]).sum(axis=-2)
        return base + cnt

    def set_intv(self, c: int) -> BiInterval:
        """Bi-interval of the single symbol c (fm6_set_intv, ping_pong.hpp:40)."""
        return BiInterval(int(self.C[c]), int(self.C[COMP6[c]]),
                          int(self.C[c + 1] - self.C[c]))

    # cumulative assignment order of the non-rank coordinate: $ then
    # complement-sorted bases then N (rb3_fmd_extend; see module docstring)
    _CUM_ORDER = (0, 4, 3, 2, 1, 5)

    def extend(self, ik: BiInterval, is_back: bool) -> Tuple[BiInterval, ...]:
        """All six child bi-intervals of ik, extended backward or forward."""
        lo = ik.x0 if is_back else ik.x1
        tk = self.rank6(lo)
        tl = self.rank6(lo + ik.size)
        cnt = tl - tk
        ok = [BiInterval(0, 0, 0) for _ in range(6)]
        for c in range(6):
            x_rank = int(self.C[c] + tk[c])
            if is_back:
                ok[c].x0 = x_rank
            else:
                ok[c].x1 = x_rank
            ok[c].size = int(cnt[c])
        acc = ik.x1 if is_back else ik.x0
        for c in self._CUM_ORDER:
            if is_back:
                ok[c].x1 = acc
            else:
                ok[c].x0 = acc
            acc += int(cnt[c])
        return tuple(ok)

    # -- convenience for tests --------------------------------------------

    def count_occurrences(self, pattern: np.ndarray) -> int:
        """Number of occurrences of an nt6 pattern (both strands counted)."""
        pattern = np.asarray(pattern, dtype=np.uint8)
        if len(pattern) == 0:
            return 0
        ik = self.set_intv(int(pattern[-1]))
        for c in pattern[-2::-1]:
            if ik.size == 0:
                return 0
            ik = self.extend(ik, True)[int(c)]
        return ik.size


def genome_text_ends(chromosomes: Dict[str, str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate nt6(S) $ nt6(revcomp(S)) $ over all chromosomes, plus
    the exclusive end offset of each sentinel-terminated string (two
    strings per chromosome) for the grouped builder."""
    parts = []
    ends = []
    total = 0
    zero = np.zeros(1, dtype=np.uint8)
    for seq in chromosomes.values():
        enc = encode_nt6(seq)
        parts.extend([enc, zero])
        total += len(enc) + 1
        ends.append(total)
        parts.extend([revcomp_nt6(enc), zero])
        total += len(enc) + 1
        ends.append(total)
    return np.concatenate(parts), np.asarray(ends, dtype=np.int64)


def genome_text(chromosomes: Dict[str, str]) -> np.ndarray:
    """Concatenate nt6(S) $ nt6(revcomp(S)) $ over all chromosomes."""
    return genome_text_ends(chromosomes)[0]


# texts below this use the in-process SA path even when the native grouped
# builder is available (tiny inputs: ctypes round-trip not worth it)
_GROUPED_MIN = 1 << 20


def build_index(chromosomes: Dict[str, str], threads: int = 1) -> FMDIndex:
    """Build the two-strand FMD index of a genome (cf. `SVDSS index`,
    main.cpp:34-37 -> ropebwt3 build).

    Large texts use the native grouped builder (per-group int32 SA-IS +
    threaded FM-walk merge, native/bwtbuild.cpp) — required past 2^31
    symbols, where a single in-RAM int64 SA-IS pass is impractical."""
    text, ends = genome_text_ends(chromosomes)
    if len(text) >= _GROUPED_MIN:
        from .suffix_array import build_bwt_grouped
        bwt = build_bwt_grouped(text, ends, threads=max(1, threads))
        if bwt is not None:
            counts = np.bincount(text, minlength=8)
            del text
            return FMDIndex(bwt, counts)
    assert len(text) < 2**31, \
        "whole-genome builds need the native library (make -C native)"
    return FMDIndex.from_text(text)
