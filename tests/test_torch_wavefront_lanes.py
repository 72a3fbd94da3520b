"""Kernel K1's register path (svdss_tpu_torch/csrc/wavefront.cu), held on
the CPU:

- the path choice: a Python mirror of `cells_for` and
  `svdss_wavefront_scratch_words`, read against the constants of the
  source, and the widths each path takes;
- a numpy mirror of the kernel's decomposition in kernel order: each
  thread owns C consecutive cells in registers, cells update from the
  thread's last to its first, a thread's first cell takes its left
  neighbour's H, F and F2 from lane - 1 (a shuffle) or, in lane 0, from the
  double-buffered exchange row that lane 31 of the warp before wrote at
  the previous diagonal, the target symbols shift one cell a diagonal,
  the score comes from the thread that owns the target cell after its
  cells update, and each warp's trace bytes pass through its stage. It is held against `wavefront_plain` and the JAX package's
  XLA twin `svdss_tpu/ops/align_jax.py:35 _wavefront` over the whole
  trace and the scores, at `chip_smoke.DP_EDGE_CASES`, the edge shapes
  the card check also runs (widths around each of the path's limits).

Integer results: equality is exact."""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import DP_EDGE_CASES, dp_edge_case
from svdss_tpu.ops.align_jax import _wavefront as jax_wavefront
from svdss_tpu_torch.ops.align_dp import NEG, wavefront_plain
from svdss_tpu_torch.pipeline.call import _CALL_PARAMS as P

WARP = 32
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "svdss_tpu_torch",
                   "csrc", "wavefront.cu")


def source_constants():
    """CELLS, MAX_THREADS and STATE_ROWS as wavefront.cu states them."""
    src = open(SRC).read()

    def arr(name):
        m = re.search(rf"constexpr int {name}\[4\] = \{{([^}}]*)\}};", src)
        return [int(x) for x in m.group(1).split(",")]
    rows = int(re.search(r"constexpr int STATE_ROWS = (\d+);", src).group(1))
    return arr("CELLS"), arr("MAX_THREADS"), rows


CELLS, MAX_THREADS, STATE_ROWS = source_constants()


def cells_for(W):
    """wavefront.cu cells_for: the register path's cells a thread at width
    W, 0 past it."""
    for c, t in zip(CELLS, MAX_THREADS):
        if W <= c * t:
            return c
    return 0


def scratch_words(lq):
    """svdss_wavefront_scratch_words."""
    return 0 if cells_for(lq + 1) else STATE_ROWS * (lq + 1)


def threads_for(W, C):
    """launch_reg's block size: whole warps covering W cells, C a thread."""
    return -(-(-(-W // C)) // WARP) * WARP


# ------------------------------------------------------- the kernel's mirror

def mirror(q, t, tgt_d, tgt_i, lq, lt, p=P):
    """wavefront_reg_kernel for every block at once ([B, threads, C] state),
    step for step in the kernel's order."""
    q, t = np.asarray(q, np.int64), np.asarray(t, np.int64)
    B = q.shape[0]
    W, D = lq + 1, lq + lt + 1
    C = cells_for(W)
    assert C, "past the register path"
    nthr = threads_for(W, C)
    assert nthr <= MAX_THREADS[CELLS.index(C)]
    nwarp = nthr // WARP
    oe1, oe2 = p.gap_open1 + p.gap_ext1, p.gap_open2 + p.gap_ext2
    cell = np.arange(nthr)[:, None] * C + np.arange(C)[None, :]  # [thr, C]
    c0 = cell[:, 0]
    warp = np.arange(nthr) // WARP

    def tsym(x):                               # [B, n] at indices x [n]
        ok = (x >= 0) & (x < lt)
        return np.where(ok[None, :], t[:, np.clip(x, 0, max(lt - 1, 0))]
                        if lt else -1, -1)
    shape = (B, nthr, C)
    h1 = np.where(cell == 0, 0, NEG)[None].repeat(B, 0).astype(np.int64)
    hd = np.full(shape, NEG, np.int64)
    e, e2, f, f2 = (np.full(shape, NEG, np.int64) for _ in range(4))
    qv = np.where((cell >= 1) & (cell <= lq),
                  q[:, np.clip(cell - 1, 0, max(lq - 1, 0))]
                  if lq else -2, -2)
    qv = np.broadcast_to(qv, shape)
    tv = np.full(shape, -1, np.int64)
    tnext = tsym(-c0)
    trace = np.zeros((B, D, W), np.uint8)
    score = np.full(B, NEG, np.int64)
    xch = np.zeros((2, B, nwarp, 3), np.int64)
    xch[0] = np.stack([h1[:, WARP - 1::WARP, C - 1], f[:, WARP - 1::WARP,
                       C - 1], f2[:, WARP - 1::WARP, C - 1]], -1)
    for d in range(1, D):
        tv[:, :, 1:] = tv[:, :, :-1].copy()
        tv[:, :, 0] = tnext
        tnext = tsym(d - c0)
        # shuffles from lane - 1; lane 0 from the exchange row or NEG
        lh, lf, lf2 = (np.roll(x[:, :, C - 1], 1, axis=1) for x in (h1, f, f2))
        row = xch[(d - 1) & 1]
        for w in range(nwarp):
            th = w * WARP
            if w == 0:
                lh[:, th] = lf[:, th] = lf2[:, th] = NEG
            else:
                lh[:, th], lf[:, th], lf2[:, th] = row[:, w - 1].T
        ilo, ihi = max(0, d - lt), min(lq, d)
        bits = np.zeros(shape, np.int64)
        for j in range(C - 1, -1, -1):
            i = cell[:, j]
            hl = h1[:, :, j - 1] if j else lh
            fl = f[:, :, j - 1] if j else lf
            f2l = f2[:, :, j - 1] if j else lf2
            e_open, e_ext = h1[:, :, j] - oe1, e[:, :, j] - p.gap_ext1
            e2_open, e2_ext = h1[:, :, j] - oe2, e2[:, :, j] - p.gap_ext2
            f_open, f_ext = hl - oe1, fl - p.gap_ext1
            f2_open, f2_ext = hl - oe2, f2l - p.gap_ext2
            Ev, E2v = np.maximum(e_open, e_ext), np.maximum(e2_open, e2_ext)
            Fv, F2v = np.maximum(f_open, f_ext), np.maximum(f2_open, f2_ext)
            best = hd[:, :, j] + np.where(qv[:, :, j] == tv[:, :, j], p.match,
                                          p.mismatch)
            src = np.zeros_like(best)
            for val, code in ((Ev, 1), (Fv, 2), (E2v, 3), (F2v, 4)):
                upd = val > best
                best = np.where(upd, val, best)
                src = np.where(upd, code, src)
            best = np.where(((i < ilo) | (i > ihi))[None], NEG, best)
            bits[:, :, j] = (src | (e_ext > e_open) << 3
                             | (f_ext > f_open) << 4
                             | (e2_ext > e2_open) << 5
                             | (f2_ext > f2_open) << 6)
            hd[:, :, j] = hl
            h1[:, :, j], e[:, :, j], e2[:, :, j] = best, Ev, E2v
            f[:, :, j], f2[:, :, j] = Fv, F2v
        # the score, from the thread that owns the target cell
        for b in np.flatnonzero(tgt_d == d):
            th, tj = divmod(int(tgt_i[b]), C)
            score[b] = h1[b, th, tj]
        # the trace row through each warp's stage: thread `lane` puts its C
        # bytes at lane * C, then byte x = j * 32 + lane is stored by
        # thread `lane` at cell warp * 32 * C + x
        stage = bits.reshape(B, nwarp, WARP * C)
        x = np.arange(WARP * C)
        for w in range(nwarp):
            cells = w * WARP * C + x
            trace[:, d, cells[cells < W]] = stage[:, w, x[cells < W]]
        xch[d & 1] = np.stack([h1[:, WARP - 1::WARP, C - 1],
                               f[:, WARP - 1::WARP, C - 1],
                               f2[:, WARP - 1::WARP, C - 1]], -1)
    return trace, score.astype(np.int32)


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("W,C", [(1, 1), (32, 1), (1024, 1), (1025, 2),
                                 (2048, 2), (2049, 4), (3072, 4), (3073, 8),
                                 (5120, 8), (5121, 0), (8193, 0)])
def test_path_choice(W, C):
    """The cells a thread at width W, the block that covers them within
    the path's thread limit, and the scratch the wrapper is asked for."""
    assert cells_for(W) == C
    if C:
        n = threads_for(W, C)
        assert n % WARP == 0 and n * C >= W > (n - WARP) * C
        assert n <= MAX_THREADS[CELLS.index(C)]
        # 8 registers of state a cell fit the registers a thread has
        assert 8 * C <= 65536 // MAX_THREADS[CELLS.index(C)]
        assert scratch_words(W - 1) == 0
    else:
        assert scratch_words(W - 1) == STATE_ROWS * W


def test_call_buckets_take_register_path():
    """The call stage's buckets up to 4,096 (W = 4,097) take the register
    path, and the card check's 8,192 x 512 bucket the global scratch."""
    for lq in (256, 512, 1024, 2048, 4096):
        assert scratch_words(lq) == 0
    assert scratch_words(8192) > 0


@pytest.mark.parametrize("case", sorted(DP_EDGE_CASES))
def test_mirror_matches_plain_and_xla(case):
    """The mirror (on the register path), the plain version and the XLA
    twin agree over the whole trace and the scores."""
    q, t, tgt_d, tgt_i, lq, lt = dp_edge_case(case)
    kind = DP_EDGE_CASES[case][3]
    want_t, want_s = wavefront_plain(*(torch.from_numpy(a) for a in
                                       (q, t, tgt_d, tgt_i)), lq, lt, P)
    want_t, want_s = want_t.numpy(), want_s.numpy()
    jt, js = jax_wavefront(q, t, tgt_d, tgt_i, lq, lt, P.match, P.mismatch,
                           P.gap_open1, P.gap_ext1, P.gap_open2, P.gap_ext2)
    assert np.array_equal(want_t, np.asarray(jt))
    assert np.array_equal(want_s, np.asarray(js))
    if cells_for(lq + 1):
        trace, score = mirror(q, t, tgt_d, tgt_i, lq, lt)
        assert np.array_equal(trace, want_t)
        assert np.array_equal(score, want_s)
    else:
        assert scratch_words(lq) > 0
    if kind == "tgt_zero":
        assert (want_s == NEG).all()
    elif kind == "mismatch":
        assert (want_s > NEG).all()
