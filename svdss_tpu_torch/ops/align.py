"""Global alignment with 2-piece (dual) affine gap costs + CIGAR traceback.

Equivalent of the reference's single call into ksw2's ``ksw_extd2_sse``
(caller.cpp:333-349): consensus vs cluster reference window, scores
match=+1, mismatch=-9, gap piece 1 open/ext=16/2, piece 2 open/ext=41/1,
no band, no zdrop — a full global alignment whose CIGAR (M/I/D) is walked
to call INS/DEL >= min_sv_length.

Host implementation: anti-diagonal numpy DP over five state matrices
(H, E, E2 horizontal = target-consuming 'D' gaps; F, F2 vertical =
query-consuming 'I' gaps) with packed traceback. The batched device version
(ops/align_jax.py) shares the same recurrence; this one is its oracle.

Tie-breaking prefers diagonal, then D, then I, and gap-open over gap-extend
(ksw2's own tie order on exactly equal scores may differ; scores are always
identical).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

NEG = -(10 ** 8)

# Hsrc codes
_DIAG, _E, _F, _E2, _F2 = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class AlignParams:
    """ksw2-style scoring; defaults are the caller's (caller.cpp:333-337)."""
    match: int = 1
    mismatch: int = -9
    gap_open1: int = 16
    gap_ext1: int = 2
    gap_open2: int = 41
    gap_ext2: int = 1

    def gap_cost(self, length: int) -> int:
        return min(self.gap_open1 + length * self.gap_ext1,
                   self.gap_open2 + length * self.gap_ext2)


DEFAULT_PARAMS = AlignParams()


def align_dual_gap(query: np.ndarray, target: np.ndarray,
                   params: AlignParams = DEFAULT_PARAMS
                   ) -> Tuple[int, List[Tuple[int, str]]]:
    """Returns (score, cigar) where cigar is [(length, op)] with op in MID.

    query/target: integer-encoded sequences (any matching encoding);
    'I' consumes query, 'D' consumes target (htslib convention, so an 'I'
    in consensus-vs-reference is an insertion candidate).
    """
    q = np.asarray(query)
    t = np.asarray(target)
    ql, tl = len(q), len(t)
    if ql == 0 and tl == 0:
        return 0, []
    if ql == 0:
        return -params.gap_cost(tl), [(tl, "D")]
    if tl == 0:
        return -params.gap_cost(ql), [(ql, "I")]
    oe1 = params.gap_open1 + params.gap_ext1
    oe2 = params.gap_open2 + params.gap_ext2
    e1, e2 = params.gap_ext1, params.gap_ext2

    H = np.full((ql + 1, tl + 1), NEG, dtype=np.int32)
    E = np.full((ql + 1, tl + 1), NEG, dtype=np.int32)
    F = np.full((ql + 1, tl + 1), NEG, dtype=np.int32)
    E2 = np.full((ql + 1, tl + 1), NEG, dtype=np.int32)
    F2 = np.full((ql + 1, tl + 1), NEG, dtype=np.int32)
    Hsrc = np.zeros((ql + 1, tl + 1), dtype=np.uint8)
    Eext = np.zeros((ql + 1, tl + 1), dtype=bool)
    Fext = np.zeros((ql + 1, tl + 1), dtype=bool)
    E2ext = np.zeros((ql + 1, tl + 1), dtype=bool)
    F2ext = np.zeros((ql + 1, tl + 1), dtype=bool)

    H[0, 0] = 0
    jj0 = np.arange(1, tl + 1)
    H[0, 1:] = -np.minimum(params.gap_open1 + e1 * jj0,
                           params.gap_open2 + e2 * jj0)
    Hsrc[0, 1:] = _E
    Eext[0, 1:] = True
    ii0 = np.arange(1, ql + 1)
    H[1:, 0] = -np.minimum(params.gap_open1 + e1 * ii0,
                           params.gap_open2 + e2 * ii0)
    Hsrc[1:, 0] = _F
    Fext[1:, 0] = True

    sub_match = np.int32(params.match)
    sub_mis = np.int32(params.mismatch)

    for d in range(2, ql + tl + 1):
        ilo = max(1, d - tl)
        ihi = min(ql, d - 1)
        if ilo > ihi:
            continue
        ii = np.arange(ilo, ihi + 1)
        jj = d - ii
        # E: horizontal (from (i, j-1))
        h_open = H[ii, jj - 1] - oe1
        e_ext = E[ii, jj - 1] - e1
        Ev = np.maximum(h_open, e_ext)
        Eext[ii, jj] = e_ext > h_open
        E[ii, jj] = Ev
        h_open2 = H[ii, jj - 1] - oe2
        e2_ext = E2[ii, jj - 1] - e2
        E2v = np.maximum(h_open2, e2_ext)
        E2ext[ii, jj] = e2_ext > h_open2
        E2[ii, jj] = E2v
        # F: vertical (from (i-1, j))
        h_openf = H[ii - 1, jj] - oe1
        f_ext = F[ii - 1, jj] - e1
        Fv = np.maximum(h_openf, f_ext)
        Fext[ii, jj] = f_ext > h_openf
        F[ii, jj] = Fv
        h_openf2 = H[ii - 1, jj] - oe2
        f2_ext = F2[ii - 1, jj] - e2
        F2v = np.maximum(h_openf2, f2_ext)
        F2ext[ii, jj] = f2_ext > h_openf2
        F2[ii, jj] = F2v
        # H: best of diag / E / F / E2 / F2 (ties: earlier wins)
        diag = H[ii - 1, jj - 1] + np.where(q[ii - 1] == t[jj - 1],
                                            sub_match, sub_mis)
        best = diag
        src = np.zeros(len(ii), dtype=np.uint8)
        for val, code in ((Ev, _E), (Fv, _F), (E2v, _E2), (F2v, _F2)):
            upd = val > best
            best = np.where(upd, val, best)
            src = np.where(upd, code, src)
        H[ii, jj] = best
        Hsrc[ii, jj] = src

    score = int(H[ql, tl])

    # traceback
    ops: List[str] = []
    i, j = ql, tl
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if i == 0:
                ops.append("D")
                j -= 1
                continue
            if j == 0:
                ops.append("I")
                i -= 1
                continue
            srcv = Hsrc[i, j]
            if srcv == _DIAG:
                ops.append("M")
                i -= 1
                j -= 1
            elif srcv in (_E, _E2):
                state = "E" if srcv == _E else "E2"
            else:
                state = "F" if srcv == _F else "F2"
        elif state in ("E", "E2"):
            ext = (Eext if state == "E" else E2ext)[i, j]
            ops.append("D")
            j -= 1
            if not ext:
                state = "H"
        else:  # F / F2
            ext = (Fext if state == "F" else F2ext)[i, j]
            ops.append("I")
            i -= 1
            if not ext:
                state = "H"

    ops.reverse()
    cigar: List[Tuple[int, str]] = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return score, cigar


def cigar_to_string(cigar: List[Tuple[int, str]]) -> str:
    return "".join(f"{ln}{op}" for ln, op in cigar)


def score_alignment(query: np.ndarray, target: np.ndarray,
                    cigar: List[Tuple[int, str]],
                    params: AlignParams = DEFAULT_PARAMS) -> int:
    """Score of a given alignment path (for validating tracebacks)."""
    qi = ti = 0
    score = 0
    for ln, op in cigar:
        if op == "M":
            for k in range(ln):
                score += (params.match if query[qi + k] == target[ti + k]
                          else params.mismatch)
            qi += ln
            ti += ln
        elif op == "I":
            score -= params.gap_cost(ln)
            qi += ln
        elif op == "D":
            score -= params.gap_cost(ln)
            ti += ln
    assert qi == len(query) and ti == len(target)
    return score
