"""Plain reference of the search stage: the SFS lists of reads, from the
reference sequence and the reads alone.

The semantics are upstream SVDSS's ping-pong search (``ping_pong.cpp``
``ping_pong_search``): from the read's end, extend backward until the
string is absent from the two-strand reference; from that position extend
forward until absent again; emit that string; restart one base left of its
end. "Absent" means: no occurrence in the forward sequence S nor in its
reverse complement. Extending forward past the read's last base counts as
absent, so an SFS that reaches the read's end is one base longer than the
rest of the read. The emitted strings are then merged where they overlap,
as the search stage's ``assemble`` step does.

Everything here is NumPy over the reference and the reads, with the two
scans over the whole reference in plain PyTorch (on the card when one is
given, else on the CPU); nothing of the program under test is imported or
read. The answers come from matching
statistics: F[a], the length of the longest prefix of P[a:] that occurs in
S or rc(S).

- Strings of up to K = 14 symbols: presence bitmaps of every j-mer
  (j <= 14) of both strands, built once per reference (`Presence`), with
  the j-mers of the last 13 symbols of each strand added apart.
- Longer strings: every genome position whose 14-mer equals a 14-mer of
  the reads (a scan of both strands per call, `Hits`). On one diagonal
  (read offset a, text position q = a + d), a run of consecutive 14-mer
  hits a0..a1 means P[a0 : a1 + 14] == T[q0 : q1 + 14] and a mismatch (or
  the end of the read or of the strand) right after, so the match from
  any a of the run is a1 + 14 - a symbols long, exactly.

``verify=False`` is the control: a string longer than 14 counts as present
when each of its 14-mers is present somewhere, with no check that they lie
on one diagonal of the text. That is the shortcut of skipping the text
verification, and it breaks the exactness guarantee.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

K = 14
CHUNK = 1 << 26


def _codes(seq: np.ndarray, k: int) -> np.ndarray:
    """uint32 codes of every k-mer of `seq` (symbols 0..3), first symbol
    most significant; len(seq) - k + 1 of them."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    out = np.zeros(n, dtype=np.uint32)
    for j in range(k):
        out <<= np.uint32(2)
        out |= seq[j:j + n].astype(np.uint32)
    return out


def _rc_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Codes of the reverse complements of k-mers given by code."""
    c = codes.astype(np.uint32)
    out = np.zeros_like(c)
    for _ in range(k):
        out <<= np.uint32(2)
        out |= np.uint32(3) - (c & np.uint32(3))
        c >>= np.uint32(2)
    return out


def _codes_t(seq: torch.Tensor, k: int) -> torch.Tensor:
    """`_codes` in PyTorch, as int64."""
    n = seq.numel() - k + 1
    out = torch.zeros(max(n, 0), dtype=torch.int64, device=seq.device)
    for j in range(k):
        out <<= 2
        out |= seq[j:j + n]
    return out


def _chunks(strand: np.ndarray, device: torch.device):
    """(offset, int64 K-mer codes) over a strand, in chunks."""
    for lo in range(0, max(0, len(strand) - K + 1), CHUNK):
        part = torch.from_numpy(strand[lo:lo + CHUNK + K - 1]).to(
            device=device, dtype=torch.int64)
        yield lo, _codes_t(part, K)


def strand_symbols(nt6: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A forward sequence in nt6 codes (A=1 .. T=4) as symbols 0..3, and
    its reverse complement."""
    s = (np.asarray(nt6, dtype=np.uint8) - 1).astype(np.uint8)
    if s.size and int(s.max()) > 3:
        raise ValueError("the reference holds a symbol other than ACGT")
    return s, (3 - s[::-1]).astype(np.uint8)


class Presence:
    """Which j-mers (1 <= j <= 14) occur in S or rc(S)."""

    def __init__(self, bits: Dict[int, np.ndarray]):
        self.bits = bits          # j -> bool [4^j]

    @classmethod
    def build(cls, fwd: np.ndarray, rev: np.ndarray,
              device: torch.device = torch.device("cpu")) -> "Presence":
        top = torch.zeros(4 ** K, dtype=torch.bool, device=device)
        for strand in (fwd, rev):
            for _, c in _chunks(strand, device):
                top[c] = True
        bits = {K: top.cpu().numpy()}
        del top
        for j in range(K - 1, 0, -1):
            bits[j] = bits[j + 1].reshape(-1, 4).any(axis=1)
        for strand in (fwd, rev):
            tail = strand[-(K - 1):]
            for j in range(1, K):
                bits[j][_codes(tail, j)] = True
        return cls(bits)

    def save(self, path: str) -> None:
        tmp = path + ".tmp.npz"
        np.savez(tmp, **{f"j{j}": np.packbits(b) for j, b in
                         self.bits.items()})
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Presence":
        with np.load(path) as z:
            return cls({j: np.unpackbits(z[f"j{j}"])[:4 ** j].astype(bool)
                        for j in range(1, K + 1)})


def _short_match(P: np.ndarray, pres: Presence) -> np.ndarray:
    """For each offset a, the longest j <= min(13, len - a) such that
    P[a : a + j] occurs (presence is closed under prefixes)."""
    L = len(P)
    out = np.zeros(L, dtype=np.int64)
    alive = np.ones(L, dtype=bool)
    for j in range(1, K):
        n = L - j + 1
        if n <= 0:
            break
        ok = np.zeros(L, dtype=bool)
        ok[:n] = pres.bits[j][_codes(P, j)]
        alive &= ok
        out += alive
    return out


class Hits:
    """Every text position whose 14-mer equals one of the reads': for each
    read, a list of (offset in the read, diagonal key)."""

    def __init__(self, reads: Sequence[np.ndarray], fwd: np.ndarray,
                 device: torch.device = torch.device("cpu")):
        rk, rr, ra = [], [], []
        for i, P in enumerate(reads):
            c = _codes(P, K)
            rk.append(c)
            rr.append(np.full(len(c), i, dtype=np.int64))
            ra.append(np.arange(len(c), dtype=np.int64))
        keys = np.concatenate(rk) if rk else np.zeros(0, np.uint32)
        rid = np.concatenate(rr) if rr else np.zeros(0, np.int64)
        roff = np.concatenate(ra) if ra else np.zeros(0, np.int64)
        order = np.argsort(keys, kind="stable")
        keys, rid, roff = keys[order], rid[order], roff[order]
        # bit 0: a read's 14-mer; bit 1: the reverse complement of one
        want = np.zeros(4 ** K, dtype=np.uint8)
        want[keys] = 1
        want[_rc_codes(keys, K)] |= 2
        want_t = torch.from_numpy(want).to(device)
        hc, hq, hs = [], [], []
        n = len(fwd)
        for lo, c in _chunks(fwd, device):
            w = want_t[c]
            for bit, strand in ((1, 0), (2, 1)):
                p = torch.nonzero(w & bit).flatten()
                cp = c[p].cpu().numpy().astype(np.uint32)
                p = p.cpu().numpy() + lo
                if strand:
                    # the 14-mer of rc(S) at n - K - p is rc of this one
                    cp, p = _rc_codes(cp, K), n - K - p
                hc.append(cp)
                hq.append(p)
                hs.append(np.full(len(p), strand, dtype=np.int64))
        del want_t
        hc = np.concatenate(hc) if hc else np.zeros(0, np.uint32)
        hq = np.concatenate(hq) if hq else np.zeros(0, np.int64)
        hs = np.concatenate(hs) if hs else np.zeros(0, np.int64)
        order = np.argsort(hc, kind="stable")
        hc, hq, hs = hc[order], hq[order], hs[order]
        # join: every (read, offset) with every text hit of its code
        lo_i = np.searchsorted(keys, hc, side="left")
        hi_i = np.searchsorted(keys, hc, side="right")
        cnt = hi_i - lo_i
        rep = np.repeat(np.arange(len(hc)), cnt)
        first = np.repeat(lo_i - np.cumsum(cnt) + cnt, cnt)
        idx = first + np.arange(len(rep))
        j_rid, j_off = rid[idx], roff[idx]
        j_q, j_s = hq[rep], hs[rep]
        # diagonal key: strand and text position minus read offset
        diag = (j_q - j_off) * 2 + j_s
        self.per_read: List[Tuple[np.ndarray, np.ndarray]] = []
        order = np.argsort(j_rid, kind="stable")
        j_rid, j_off, diag = j_rid[order], j_off[order], diag[order]
        bounds = np.searchsorted(j_rid, np.arange(len(reads) + 1))
        for i in range(len(reads)):
            a, b = bounds[i], bounds[i + 1]
            self.per_read.append((j_off[a:b], diag[a:b]))


def _long_match(L: int, offs: np.ndarray, diag: np.ndarray) -> np.ndarray:
    """F[a] from the 14-mer hits of one read (0 where a has none)."""
    F = np.zeros(L, dtype=np.int64)
    if len(offs) == 0:
        return F
    order = np.lexsort((offs, diag))
    a, d = offs[order], diag[order]
    # a run continues while the diagonal is the same and a steps by one
    brk = np.ones(len(a), dtype=bool)
    brk[1:] = (d[1:] != d[:-1]) | (a[1:] != a[:-1] + 1)
    run = np.cumsum(brk) - 1
    last = np.zeros(run[-1] + 1, dtype=np.int64)
    np.maximum.at(last, run, a)
    np.maximum.at(F, a, last[run] + K - a)
    return F


def _chain_match(P: np.ndarray, pres: Presence) -> np.ndarray:
    """The control's F[a] for a with a present 14-mer: 13 plus the number
    of consecutive present 14-mers from a."""
    L = len(P)
    F = np.zeros(L, dtype=np.int64)
    n = L - K + 1
    if n <= 0:
        return F
    ok = pres.bits[K][_codes(P, K)]
    idx = np.arange(n, dtype=np.int64)
    next_absent = np.minimum.accumulate(np.where(ok, n, idx)[::-1])[::-1]
    F[:n] = np.where(ok, next_absent - idx + K - 1, 0)
    return F


def ping_pong(F: np.ndarray) -> List[Tuple[int, int]]:
    """The ping-pong search's (start, length) pairs, in emission order,
    from the matching statistics F of a read."""
    L = len(F)
    G = np.arange(L, dtype=np.int64) + F     # P[b..r] occurs iff G[b] > r
    out: List[Tuple[int, int]] = []
    r = L - 1
    while r >= 0:
        b, w = -1, 64
        lo = r + 1
        while lo > 0:
            nlo = max(0, lo - w)
            seg = np.flatnonzero(G[nlo:lo] <= r)
            if len(seg):
                b = nlo + int(seg[-1])
                break
            lo, w = nlo, w * 2
        if b < 0:
            break                  # P[0..r] occurs: no SFS left
        out.append((b, int(F[b]) + 1))
        if b == 0:
            break
        r = b + int(F[b]) - 1
    return out


def assemble(pairs: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The search stage's merge: sorted by start, a string joins the group
    of the one before it when that one ends past its start, and a group
    becomes one string from its first start to its last string's end."""
    s = sorted(pairs, key=lambda p: p[0])
    out: List[Tuple[int, int]] = []
    i = 0
    while i < len(s):
        j = i + 1
        while j < len(s) and s[j - 1][0] + s[j - 1][1] > s[j][0]:
            j += 1
        out.append((s[i][0], s[j - 1][0] + s[j - 1][1] - s[i][0]))
        i = j
    return out


def sfs_lists(reads: Sequence[np.ndarray], fwd: np.ndarray,
              pres: Presence, verify: bool = True, merged: bool = True,
              device: torch.device = torch.device("cpu")
              ) -> List[List[Tuple[int, int]]]:
    """Each read's SFS list (reads in nt6 codes), merged as the search
    stage emits them unless merged=False. verify=False is the control."""
    syms = [strand_symbols(r)[0] for r in reads]
    hits = Hits(syms, fwd, device) if verify else None
    out = []
    for i, P in enumerate(syms):
        F = _short_match(P, pres)
        longF = (_long_match(len(P), *hits.per_read[i]) if verify
                 else _chain_match(P, pres))
        F = np.maximum(F, longF)
        pairs = ping_pong(F)
        out.append(assemble(pairs) if merged else pairs)
    return out
