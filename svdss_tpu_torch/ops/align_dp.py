"""Batched dual-affine global alignment on the device (anti-diagonal DP).

Device counterpart of ops/align.py (the ksw2 ``ksw_extd2_sse`` equivalent,
caller.cpp:333-349): many (consensus, reference-window) pairs are aligned
in one launch. Scores and per-cell traceback bits are computed on the
device along anti-diagonals; the CIGAR walk runs on the host from the
trace.

Trace layout: uint8[B, D, lq+1] where D = lq + lt + 1 and entry [b, d, i]
describes cell (i, j = d - i):
    bits 0-2: H source (0 diag, 1 E, 2 F, 3 E2, 4 F2)
    bit 3: E came from E (gap extension), bit 4: F from F,
    bit 5: E2 from E2,                    bit 6: F2 from F2.

Ties break as in ops/align.py (diag > E > F > E2 > F2; a gap open wins a
tie with its extension), so device and host CIGARs are identical.

`wavefront` launches kernel K1 (``csrc/wavefront.cu``) on CUDA tensors and
runs `wavefront_plain`, the same recurrence as a loop of tensor ops over
the diagonals, on CPU tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .align import AlignParams, DEFAULT_PARAMS
from ..utils.device import (check_launch, load_kernels, resolve_device,
                            stream_handle)

NEG = -(10 ** 8)

launches = 0                  # kernel K1 launches since the last reset


def wavefront(q: torch.Tensor, t: torch.Tensor, tgt_d: torch.Tensor,
              tgt_i: torch.Tensor, lq: int, lt: int,
              params: AlignParams = DEFAULT_PARAMS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [B, lq] int32, t: [B, lt] int32 (padded with -3 / -4);
    tgt_d/tgt_i: [B] int32, each pair's final cell (true_lq + true_lt,
    true_lq), with 0 <= tgt_i <= lq. Returns (trace [B, D, lq+1] uint8, final score [B] int32;
    NEG where tgt_d is 0)."""
    B = q.shape[0]
    if q.dtype != torch.int32 or t.dtype != torch.int32 \
            or tgt_d.dtype != torch.int32 or tgt_i.dtype != torch.int32:
        raise TypeError("wavefront takes int32 tensors")
    if q.shape != (B, lq) or t.shape != (B, lt) or tgt_d.shape != (B,) \
            or tgt_i.shape != (B,):
        raise ValueError("wavefront: q [B, lq], t [B, lt], tgt_d/tgt_i [B]")
    if len({q.device, t.device, tgt_d.device, tgt_i.device}) != 1:
        raise ValueError("wavefront: all tensors must share one device")
    if q.is_cuda:
        return _launch(q.contiguous(), t.contiguous(), tgt_d.contiguous(),
                       tgt_i.contiguous(), lq, lt, params)
    return wavefront_plain(q, t, tgt_d, tgt_i, lq, lt, params)


def scratch_words(lq: int, device: torch.device) -> int:
    """int32 words of global DP scratch kernel K1 needs per pair at query
    length lq on `device` (a CUDA device); 0 when its state fits in shared
    memory there. The kernel library decides, from the card's limit."""
    with torch.cuda.device(device):
        words = load_kernels()["wavefront"].svdss_wavefront_scratch_words(lq)
    if words < 0:
        check_launch(-words, "wavefront_dp shared-memory query")
    return words


def _launch(q, t, tgt_d, tgt_i, lq, lt, p: AlignParams):
    global launches
    B = q.shape[0]
    W, D = lq + 1, lq + lt + 1
    dev = q.device
    lib = load_kernels()["wavefront"]
    trace = torch.empty((B, D, W), dtype=torch.uint8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    words = scratch_words(lq, dev)
    scratch = (torch.empty((B, words), dtype=torch.int32, device=dev)
               if words else None)
    rc = lib.svdss_wavefront_dp(
        q.data_ptr(), t.data_ptr(), tgt_d.data_ptr(), tgt_i.data_ptr(), B,
        lq, lt, p.match, p.mismatch, p.gap_open1, p.gap_ext1, p.gap_open2,
        p.gap_ext2, trace.data_ptr(), score.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        stream_handle(dev))
    check_launch(rc, "wavefront_dp")
    launches += 1
    return trace, score


def wavefront_plain(q, t, tgt_d, tgt_i, lq: int, lt: int,
                    p: AlignParams = DEFAULT_PARAMS):
    """Plain PyTorch version of kernel K1: one iteration per diagonal over
    all pairs, every cell computed and only H masked to the valid band
    (E/F/E2/F2 at invalid cells drift from NEG and feed later cells)."""
    B = q.shape[0]
    W, D = lq + 1, lq + lt + 1
    dev = q.device
    i32 = dict(dtype=torch.int32, device=dev)
    oe1, oe2 = p.gap_open1 + p.gap_ext1, p.gap_open2 + p.gap_ext2
    ii = torch.arange(W, **i32)
    H2 = torch.full((B, W), NEG, **i32)
    H1 = H2.clone()
    H1[:, 0] = 0                                  # cell (0, 0) on d = 0
    E, F, E2, F2 = (H2.clone() for _ in range(4))
    trace = torch.zeros((B, D, W), dtype=torch.uint8, device=dev)
    score = torch.full((B,), NEG, **i32)
    # t[d-i-1] = tr_pad[lt - d + W + i], -1 outside the target
    pad = torch.full((B, W), -1, **i32)
    tr_pad = torch.cat([pad, t.flip(1), pad], dim=1)
    qcmp = torch.cat([torch.full((B, 1), -2, **i32), q], dim=1)
    negcol = torch.full((B, 1), NEG, **i32)
    cell = tgt_i.long()[:, None]

    def shift(x):                                 # x[:, i-1], NEG at i = 0
        return torch.cat([negcol, x[:, :-1]], dim=1)

    for d in range(1, D):
        valid = (ii >= max(0, d - lt)) & (ii <= min(lq, d))
        e_open, e_ext = H1 - oe1, E - p.gap_ext1
        e2_open, e2_ext = H1 - oe2, E2 - p.gap_ext2
        H1s = shift(H1)
        f_open, f_ext = H1s - oe1, shift(F) - p.gap_ext1
        f2_open, f2_ext = H1s - oe2, shift(F2) - p.gap_ext2
        E, E2 = torch.maximum(e_open, e_ext), torch.maximum(e2_open, e2_ext)
        F, F2 = torch.maximum(f_open, f_ext), torch.maximum(f2_open, f2_ext)
        tslice = tr_pad[:, lt - d + W:lt - d + 2 * W]
        sub = torch.where(qcmp == tslice, p.match, p.mismatch)
        best = shift(H2) + sub.to(torch.int32)
        src = torch.zeros((B, W), **i32)
        for val, code in ((E, 1), (F, 2), (E2, 3), (F2, 4)):
            upd = val > best
            best = torch.where(upd, val, best)
            src = torch.where(upd, code, src)
        best = torch.where(valid, best, NEG)
        trace[:, d] = (src | ((e_ext > e_open).int() << 3)
                       | ((f_ext > f_open).int() << 4)
                       | ((e2_ext > e2_open).int() << 5)
                       | ((f2_ext > f2_open).int() << 6)).to(torch.uint8)
        score = torch.where(tgt_d == d, best.gather(1, cell)[:, 0], score)
        H2, H1 = H1, best
    return trace, score


def traceback(trace: np.ndarray, lq: int, lt: int
              ) -> List[Tuple[int, str]]:
    """CIGAR [(length, op)] from one pair's [D, W] trace, walked back from
    cell (lq, lt)."""
    ops: List[str] = []
    i, j = lq, lt
    state = "H"
    while i > 0 or j > 0:
        tb = int(trace[i + j, i])
        if state == "H":
            if i == 0:
                ops.append("D")
                j -= 1
                continue
            if j == 0:
                ops.append("I")
                i -= 1
                continue
            src = tb & 7
            if src == 0:
                ops.append("M")
                i -= 1
                j -= 1
            elif src in (1, 3):
                state = "E" if src == 1 else "E2"
            else:
                state = "F" if src == 2 else "F2"
        elif state in ("E", "E2"):
            ext = bool(tb & (8 if state == "E" else 32))
            ops.append("D")
            j -= 1
            if not ext:
                state = "H"
        else:
            ext = bool(tb & (16 if state == "F" else 64))
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
    return cigar


def batch_align(pairs: List[Tuple[np.ndarray, np.ndarray]],
                params: AlignParams = DEFAULT_PARAMS,
                pad_q: int = 0, pad_t: int = 0, device=None
                ) -> List[Tuple[int, List[Tuple[int, str]]]]:
    """Align a batch of (query, target) int arrays on `device` (cuda
    unless asked otherwise); returns per pair (score, cigar). Pads to the
    batch's longest pair, or to pad_q/pad_t if larger."""
    if not pairs:
        return []
    dev = resolve_device(device)
    out: List = [None] * len(pairs)
    work = []
    for k, (qa, ta) in enumerate(pairs):
        if len(qa) == 0 or len(ta) == 0:
            # degenerate: all-gap alignment (matches ops/align.py)
            if len(qa) == 0 and len(ta) == 0:
                out[k] = (0, [])
            elif len(qa) == 0:
                out[k] = (-params.gap_cost(len(ta)), [(len(ta), "D")])
            else:
                out[k] = (-params.gap_cost(len(qa)), [(len(qa), "I")])
        else:
            work.append(k)
    if not work:
        return out
    lq = max(max(len(pairs[k][0]) for k in work), pad_q)
    lt = max(max(len(pairs[k][1]) for k in work), pad_t)
    B = len(work)
    q = np.full((B, lq), -3, dtype=np.int32)
    t = np.full((B, lt), -4, dtype=np.int32)
    for b, k in enumerate(work):
        q[b, :len(pairs[k][0])] = pairs[k][0]
        t[b, :len(pairs[k][1])] = pairs[k][1]
    tgt_d = np.array([len(pairs[k][0]) + len(pairs[k][1]) for k in work],
                     dtype=np.int32)
    tgt_i = np.array([len(pairs[k][0]) for k in work], dtype=np.int32)
    trace, score = wavefront(*(torch.from_numpy(a).to(dev)
                               for a in (q, t, tgt_d, tgt_i)),
                             lq, lt, params)
    trace = trace.cpu().numpy()
    score = score.cpu().numpy()
    for b, k in enumerate(work):
        out[k] = (int(score[b]),
                  traceback(trace[b], len(pairs[k][0]), len(pairs[k][1])))
    return out
