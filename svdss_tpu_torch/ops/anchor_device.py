"""Narrow anchor-verify SFS search on the device: tables and one-shot batches.

The device form of ops/anchor.py (whose serial `anchor_search` is pinned
against the FM oracle). Each lane is one read and a restart-level state
machine instead of the per-base FM walk of ops/pingpong.py:

    KEY  read the k-mer at the cursor, look up its meta row
    SUB  presence-bitmap cascade for an absent k-mer (m < k)
    POS  fetch the next row of four occurrence positions
    VER  compare the read with the text at one occurrence

Backward phases run forward on the reverse complement of the read (the
two-strand text is closed under reverse complement, so the backward
matching statistic at r is the forward one of RC(P) at L-1-r, with the same
occurrence counts). Lanes that need the exact FM path (a non-ACGT symbol in
a key window, a k-mer above cmax, the round budget) come back
``incomplete``; lanes with more than ``cap`` SFSs come back ``overflow``;
the search stage redoes both on the host.

On a CUDA tensor `batch_search_anchor` launches kernel K3
(``csrc/anchor.cu``), one warp per lane, run to completion; on a CPU
tensor it runs `batch_search_anchor_plain`, the lockstep loop of the JAX
package's ``ops/anchor_jax.py`` written out in tensor ops over all lanes.
Both give that module's six result fields exactly, including which lanes
are incomplete and the round count: those follow the JAX package's row
layout (reads and text in 128-symbol rows at stride 64, overflow checked
every 8 rounds), which the kernel reproduces arithmetically.

Table layout (`build_device_anchor`, the same rows as the JAX package's):

    small [X, 4] int32
      rows [0, 4^k)        meta (cnt, aux, x0, x1): cnt == 0: x0 = presence
                           of the (k-1)-prefix; cnt == 1: aux = the single
                           occurrence; cnt >= 2: aux = poslist offset,
                           x0/x1 = the first two occurrences
      rows [pos_base, ..)  poslist, four positions per row
      rows [bm_bases_j, ..) presence bitmaps of levels j0 < j < k, four
                           uint32 words per row
    text_words [n//64 + 1, 16] int32: row m holds the 128 text symbols
                           from 64*m, nibble-packed (position p in word
                           p >> 3, nibble p & 7), zero past n
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .anchor import AnchorIndex
from .pingpong import PingPongResult
from ..utils.device import (check_launch, load_kernels, resolve_device,
                            stream_handle)

SPAN = 128        # symbols per read or text row
STRIDE = 64       # row stride in symbols
SPAN_W = 16       # int32 words per text row
STAGE_EVERY = 8   # rounds between overflow checks

# lane modes
KEY, SUB, POS, VER = 0, 1, 2, 3

# the `work` counters: lane rounds, small-table rows read, text rows
# compared against, symbols compared
WORK_FIELDS = ("rounds", "table_rows", "text_rows", "symbols")

launches = 0     # kernel K3 launches since the last reset


class DeviceAnchorIndex(NamedTuple):
    small: torch.Tensor       # [X, 4] int32
    text_words: torch.Tensor  # [n // 64 + 1, 16] int32

    @property
    def device(self) -> torch.device:
        return self.small.device

    @property
    def nbytes(self) -> int:
        return (self.small.numel() + self.text_words.numel()) * 4


@dataclasses.dataclass(frozen=True)
class AnchorParams:
    k: int
    j0: int
    cmax: int
    n: int
    pos_base: int                 # row offset of the poslist rows
    bm_bases: Tuple[int, ...]     # row offset per level j0+1 .. k-1


def pack_text_words(text: np.ndarray) -> np.ndarray:
    """nt6 uint8 [n] -> [n//64 + 1, 16] int32 text rows: row m holds the
    128 symbols from 64*m, nibble-packed (position p of a row in word
    p >> 3, nibble p & 7). Past n the rows hold zeros."""
    n = len(text)
    nrow = n // STRIDE + 1
    sym = np.zeros((nrow + 1) * STRIDE, dtype=np.uint8)
    sym[:n] = text
    spans = np.lib.stride_tricks.as_strided(
        sym, shape=(nrow, SPAN), strides=(STRIDE, 1)).astype(np.uint32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    words = (spans.reshape(nrow, SPAN // 8, 8)
             << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
    return words.astype(np.int32)


def from_arrays(small: np.ndarray, text_words: np.ndarray, params,
                device=None) -> Tuple[DeviceAnchorIndex, AnchorParams]:
    """Device tables from their host arrays (the JAX package's
    `DeviceAnchorIndex` fields, as numpy, carry across unchanged);
    `params` is any object with the `AnchorParams` fields."""
    dev = resolve_device(device)
    small = np.ascontiguousarray(small, dtype=np.int32)
    text_words = np.ascontiguousarray(text_words, dtype=np.int32)
    if small.ndim != 2 or small.shape[1] != 4 \
            or text_words.ndim != 2 or text_words.shape[1] != SPAN_W:
        raise ValueError("small must be [X, 4] and text_words [nrow, 16]")
    p = AnchorParams(k=int(params.k), j0=int(params.j0),
                     cmax=int(params.cmax), n=int(params.n),
                     pos_base=int(params.pos_base),
                     bm_bases=tuple(int(b) for b in params.bm_bases))
    if text_words.shape[0] != p.n // STRIDE + 1:
        raise ValueError("text_words does not match params.n")
    return DeviceAnchorIndex(_to_device(small, dev),
                             _to_device(text_words, dev)), p


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # torch cannot wrap a read-only array (a JAX array's numpy view)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)


def build_device_anchor(aidx: AnchorIndex, device=None
                        ) -> Tuple[DeviceAnchorIndex, AnchorParams]:
    """Build the device tables of a host `AnchorIndex` on `device` (cuda
    unless asked otherwise). `small` is allocated once at its final size
    and filled in place (its meta rows alone are 4 GiB at k = 14)."""
    dev = resolve_device(device)
    k, j0 = aidx.k, aidx.j0
    nk = 4 ** k
    pl_rows = -(-len(aidx.poslist) // 4)
    bm_rows = [-(-len(aidx.levels[j]) // 4) for j in range(j0 + 1, k)]
    small = np.zeros((nk + pl_rows + sum(bm_rows), 4), dtype=np.int32)
    meta4 = small[:nk]
    cnt = aidx.meta[:, 0]
    auxm = aidx.meta[:, 1]
    meta4[:, 0] = cnt
    meta4[:, 1] = auxm
    multi = cnt >= 2
    off = auxm[multi].astype(np.int64)
    meta4[multi, 2] = aidx.poslist[off]
    meta4[multi, 3] = aidx.poslist[off + 1]
    del multi, off
    empty = cnt == 0
    if k - 1 > j0:
        bm = aidx.levels[k - 1]
        pref = np.nonzero(empty)[0] >> 2          # first k-1 symbols
        meta4[empty, 2] = (bm[pref >> 5] >> (pref & 31)) & 1
        del pref
    else:
        meta4[empty, 2] = 1                       # all (k-1)-mers occur
    del empty
    pos_base = nk
    small.reshape(-1)[4 * nk:4 * nk + len(aidx.poslist)] = aidx.poslist
    row = pos_base + pl_rows
    bm_bases = []
    for j, nrows in zip(range(j0 + 1, k), bm_rows):
        bm = aidx.levels[j]
        small.reshape(-1)[4 * row:4 * row + len(bm)] = bm.view(np.int32)
        bm_bases.append(row)
        row += nrows
    params = AnchorParams(k=k, j0=j0, cmax=aidx.cmax, n=aidx.n,
                          pos_base=pos_base, bm_bases=tuple(bm_bases))
    return from_arrays(small, pack_text_words(aidx.text), params, dev)


def chunk_rows(lp1: int) -> int:
    """128-symbol read rows per side in the JAX layout for a padded width:
    the read padded to a multiple of 64 symbols plus one 64-symbol row of
    slack, as rows of 128 at stride 64."""
    return (lp1 + 63) // 64


def default_max_rounds(lp1: int) -> int:
    return 6 * (lp1 - 1) + 64


# ------------------------------------------------------------- entry point

def batch_search_anchor(index: DeviceAnchorIndex, params: AnchorParams,
                        seqs: torch.Tensor, lens: torch.Tensor,
                        cap: int = 128, max_rounds: int = 0,
                        overlap: int = -1,
                        budget: Optional[torch.Tensor] = None,
                        work: Optional[torch.Tensor] = None
                        ) -> PingPongResult:
    """Anchor-verify ping-pong over a padded read batch.

    seqs: [Q, L+1] uint8 nt6, 0-padded; lens: [Q] int32. max_rounds=0
    means 6*L + 64. budget: optional int32 [Q] per-lane round budget (a
    lane still running after that many of its own rounds is flagged
    incomplete, as in the pool). work: optional int64 [4] tensor to which
    the `WORK_FIELDS` counts are added (a measurement aid)."""
    Q, Lp1 = seqs.shape
    if seqs.dtype != torch.uint8 or lens.dtype != torch.int32 \
            or lens.shape != (Q,):
        raise TypeError("seqs must be uint8 [Q, L+1] and lens int32 [Q]")
    if budget is not None and (budget.dtype != torch.int32
                               or budget.shape != (Q,)):
        raise TypeError("budget must be int32 [Q]")
    if work is not None and (work.dtype != torch.int64
                             or work.shape != (len(WORK_FIELDS),)):
        raise TypeError("work must be int64 [4]")
    devs = {t.device for t in (seqs, lens, budget, work, index.small,
                               index.text_words) if t is not None}
    if len(devs) != 1:
        raise ValueError("index, seqs, lens, budget and work must share "
                         "one device")
    if cap < 1:
        raise ValueError("cap must be >= 1")
    if max_rounds == 0:
        max_rounds = default_max_rounds(Lp1)
    if seqs.is_cuda:
        return _launch(index, params, seqs.contiguous(), lens.contiguous(),
                       cap, max_rounds, overlap,
                       None if budget is None else budget.contiguous(), work)
    return batch_search_anchor_plain(index, params, seqs, lens, cap,
                                     max_rounds, overlap, budget, work)


def table_args(index: DeviceAnchorIndex, params: AnchorParams):
    """(bm, args): the leading arguments every anchor kernel entry point
    takes; `args` points into the host array `bm`, which the caller keeps
    alive across the call."""
    small, tw = index.small, index.text_words
    if (small.dtype != torch.int32 or small.dim() != 2
            or small.shape[1] != 4 or not small.is_contiguous()
            or tw.dtype != torch.int32 or tw.dim() != 2
            or tw.shape[1] != SPAN_W or not tw.is_contiguous()
            or tw.shape[0] != params.n // STRIDE + 1):
        raise TypeError("index must hold contiguous int32 [X, 4] and "
                        "[n//64 + 1, 16] tables")
    if not 1 <= params.k <= 15:
        raise ValueError("anchor k must be in [1, 15]")
    bm = np.zeros(16, dtype=np.int32)
    bm[params.j0 + 1:params.k] = params.bm_bases
    return bm, [small.data_ptr(), small.shape[0], tw.data_ptr(), params.n,
                params.k, params.j0, params.cmax, params.pos_base,
                bm.ctypes.data]


def _launch(index, params, seqs, lens, cap, max_rounds, overlap, budget,
            work) -> PingPongResult:
    global launches
    Q, Lp1 = seqs.shape
    dev = seqs.device
    bm, targs = table_args(index, params)
    lib = load_kernels()["anchor"]
    out_qs = torch.empty((Q, cap), dtype=torch.int32, device=dev)
    out_l = torch.empty((Q, cap), dtype=torch.int32, device=dev)
    n_sfs = torch.empty(Q, dtype=torch.int32, device=dev)
    overflow = torch.empty(Q, dtype=torch.bool, device=dev)
    incomplete = torch.empty(Q, dtype=torch.bool, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    rc = lib.svdss_anchor_batch(
        *targs, seqs.data_ptr(), lens.data_ptr(),
        budget.data_ptr() if budget is not None else None, Q, Lp1, cap,
        max_rounds, overlap, out_qs.data_ptr(), out_l.data_ptr(),
        n_sfs.data_ptr(), overflow.data_ptr(), incomplete.data_ptr(),
        iters.data_ptr(), work.data_ptr() if work is not None else None,
        stream_handle(dev))
    check_launch(rc, "anchor_batch")
    launches += 1
    return PingPongResult(out_qs, out_l, n_sfs, overflow, incomplete, iters)


# --------------------------------------------------------- plain version

def read_rows(seqs: torch.Tensor) -> torch.Tensor:
    """[Q, Lp1] uint8 -> [Q, 2 * nwm, 128] uint8 read rows of the JAX
    layout: side 0 is the read zero-padded to 64 * (nwm + 1) symbols, side
    1 the complement of that padded buffer reversed (so logical RC position
    x sits at x + 64 * (nwm + 1) - len); row m of a side holds its symbols
    [64m, 64m + 128)."""
    Q, Lp1 = seqs.shape
    nwm = chunk_rows(Lp1)
    sp = torch.zeros((Q, STRIDE * (nwm + 1)), dtype=torch.uint8,
                     device=seqs.device)
    sp[:, :Lp1] = seqs
    rev = sp.flip(1)
    rc = torch.where((rev >= 1) & (rev <= 4), 5 - rev, rev)
    both = torch.stack([sp, rc], dim=1)
    return both.unfold(2, SPAN, STRIDE).reshape(Q, 2 * nwm, SPAN)


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """[Q, 16] int32 nibble-packed rows -> [Q, 128] int32 symbols."""
    sh = torch.arange(8, device=words.device, dtype=torch.int64) * 4
    sym = ((words.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> sh) & 0xF
    return sym.reshape(words.shape[0], SPAN).to(torch.int32)


def batch_search_anchor_plain(index: DeviceAnchorIndex,
                              params: AnchorParams, seqs: torch.Tensor,
                              lens: torch.Tensor, cap: int, max_rounds: int,
                              overlap: int = -1,
                              budget: Optional[torch.Tensor] = None,
                              work: Optional[torch.Tensor] = None
                              ) -> PingPongResult:
    """Plain PyTorch version of kernel K3: the JAX package's round body
    (anchor_jax._make_round_body), staging merge (_merge_stage) and
    while-loops, written out over [Q] tensors. All lanes advance in
    lockstep; emissions are staged and merged into [Q, cap] every 8
    rounds, when overflowed lanes stop."""
    dev = seqs.device
    Q, Lp1 = seqs.shape
    k, j0, cmax = params.k, params.j0, params.cmax
    nwm = chunk_rows(Lp1)
    rows = read_rows(seqs)
    lens = lens.to(torch.int32)
    lane = torch.arange(Q, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    small = index.small
    X = small.shape[0]
    nrow = index.text_words.shape[0]
    bm_bases = torch.tensor(
        ((0,) * (j0 + 1) + params.bm_bases + (0,))[:k], **i32)
    c128 = torch.arange(SPAN, device=dev, dtype=torch.int32)[None, :]
    st_iota = torch.arange(STAGE_EVERY, device=dev, dtype=torch.int32)

    def z():
        return torch.zeros(Q, **i32)

    s = dict(active=lens >= 1, fb=torch.zeros(Q, dtype=torch.bool,
                                              device=dev),
             dirb=torch.ones(Q, **i32), mode=torch.full((Q,), KEY, **i32),
             anc=lens - 1, key=z(), subj=z(), cnt=z(), aux=z(), occ_i=z(),
             prow=torch.full((Q,), -1, **i32), p0=z(), p1=z(), p2=z(),
             p3=z(), occ1c=z(), occ_pos=z(), ext=z(), best=z(), nsfs=z(),
             overflow=torch.zeros(Q, dtype=torch.bool, device=dev),
             nstage=z(), stage_qs=torch.zeros((Q, STAGE_EVERY), **i32),
             stage_l=torch.zeros((Q, STAGE_EVERY), **i32), age=z())
    # one spare column takes the writes that fall past cap
    out_qs = torch.zeros((Q, cap + 1), **i32)
    out_l = torch.zeros((Q, cap + 1), **i32)

    def sym_at(row, off):
        ok = (off >= 0) & (off < SPAN)
        got = row.gather(1, off.clamp(0, SPAN - 1)[:, None].long())[:, 0]
        return torch.where(ok, got, 0)

    def round_body():
        active = s["active"] & ~s["fb"] & (s["nstage"] < STAGE_EVERY)
        dirb, mode, anc = s["dirb"], s["mode"], s["anc"]
        is_b = dirb == 1
        u = torch.where(is_b, lens - 1 - anc, anc)
        maxlen = torch.where(is_b, anc + 1, lens - anc)
        mk = torch.clamp(maxlen, max=k)
        is_key = active & (mode == KEY)
        is_sub = active & (mode == SUB)
        is_pos = active & (mode == POS)
        is_ver = active & (mode == VER)

        # read row: KEY lanes read at u, VER lanes at u + k + ext
        rstart = torch.where(is_ver, u + k + s["ext"], u)
        rstart = rstart + torch.where(is_b, (nwm + 1) * STRIDE - lens, 0)
        m_r = torch.clamp(rstart >> 6, 0, nwm - 1)
        chunk = rows[lane, (dirb * nwm + m_r).long()].to(torch.int32)
        col_a = rstart - (m_r << 6)

        # KEY: k symbols from the row, key digit i = symbol u + k-1-i
        key = z()
        validm = z()
        for i in range(k):
            sym = sym_at(chunk, col_a + i)
            ok = (sym >= 1) & (sym <= 4)
            key = key | (torch.clamp(sym - 1, 0, 3) << (2 * (k - 1 - i)))
            validm = validm | torch.where(ok, 1 << i, 0)
        need_mask = torch.where(mk >= 31, 2 ** 31 - 1,
                                (1 << mk.clamp(0, 30)) - 1)
        clean = (validm & need_mask) == need_mask
        floor_case = is_key & (maxlen <= j0)
        fb_new = is_key & ~clean
        use_meta = is_key & clean & (maxlen >= k)
        to_sub_short = is_key & clean & (maxlen > j0) & (maxlen < k)

        # one small-table row per lane: meta (KEY), bitmap (SUB) or four
        # positions (POS)
        key_j = s["key"] >> (2 * (k - torch.clamp(s["subj"], 1, k)))
        w_idx = key_j >> 5
        bm_row = bm_bases[torch.clamp(s["subj"], 0, k - 1).long()] \
            + (w_idx >> 2)
        pos_row = params.pos_base + ((s["aux"] + s["occ_i"]) >> 2)
        srow_idx = torch.where(use_meta, key, torch.where(
            is_sub, bm_row, torch.where(is_pos, pos_row, 0)))
        srow = small[torch.clamp(srow_idx, 0, X - 1).long()]
        s0, s1, s2, s3 = srow[:, 0], srow[:, 1], srow[:, 2], srow[:, 3]

        def quad_sel(sel):
            lo = torch.where((sel & 1) == 1, s1, s0)
            hi = torch.where((sel & 1) == 1, s3, s2)
            return torch.where((sel & 2) == 2, hi, lo)

        # KEY dispatch from the meta row
        cnt_k, aux_k = s0, s1
        k_empty = use_meta & (cnt_k == 0)
        k_single = use_meta & (cnt_k == 1)
        k_multi = use_meta & (cnt_k >= 2) & (cnt_k <= cmax)
        k_heavy = use_meta & (cnt_k > cmax)
        fb_new = fb_new | k_heavy
        occ0 = s2
        ke_present = k_empty & (s2 == 1)
        if k - 2 <= j0:
            ke_floor = k_empty & (s2 == 0)
            ke_cont = torch.zeros_like(k_empty)
        else:
            ke_floor = torch.zeros_like(k_empty)
            ke_cont = k_empty & (s2 == 0)

        pos_take = is_pos
        occ_from_row = quad_sel(s["aux"] + s["occ_i"])
        chained = k_single | k_multi | pos_take
        ver_like = is_ver | chained
        occ_eff = torch.where(k_single, aux_k, torch.where(
            k_multi, occ0, torch.where(pos_take, occ_from_row,
                                       s["occ_pos"])))
        ext_eff = torch.where(is_ver, s["ext"], 0)
        occ_i_eff = torch.where(is_key, 0, s["occ_i"])
        cnt_eff = torch.where(use_meta, cnt_k, s["cnt"])
        best_eff = torch.where(is_key, 0, s["best"])
        aux_eff = torch.where(use_meta, aux_k, s["aux"])
        prow_eff = torch.where(k_multi, -1, torch.where(
            pos_take, (s["aux"] + s["occ_i"]) >> 2, s["prow"]))
        p0_eff = torch.where(pos_take, s0, s["p0"])
        p1_eff = torch.where(pos_take, s1, s["p1"])
        p2_eff = torch.where(pos_take, s2, s["p2"])
        p3_eff = torch.where(pos_take, s3, s["p3"])
        occ1c_eff = torch.where(k_multi, s3, s["occ1c"])
        # chained lanes read their row at u: compare from k symbols in
        cmp_off = torch.where(is_ver, col_a, col_a + k)

        # text row, aligned to the read row's phase; first mismatch at or
        # after cmp_off bounds this round's run
        tstart = occ_eff + k + ext_eff
        tr = torch.clamp(tstart >> 6, 0, nrow - 1)
        trow = _unpack_words(
            index.text_words[torch.where(ver_like, tr, 0).long()])
        col_t = tstart - (tr << 6)
        src = c128 + (col_t - cmp_off)[:, None]
        shifted = torch.where(
            (src >= 0) & (src < SPAN),
            trow.gather(1, src.clamp(0, SPAN - 1).long()), 0)
        mism = (shifted != chunk) & (c128 >= cmp_off[:, None])
        firstc = torch.where(mism, c128, SPAN).amin(dim=1)
        first = torch.where(firstc >= SPAN, SPAN, firstc - cmp_off)
        run_valid = SPAN - torch.maximum(cmp_off, col_t)
        vcap = maxlen - k
        run_cap = vcap - ext_eff
        run = torch.minimum(torch.minimum(first, run_valid), run_cap)
        ext_new = ext_eff + torch.clamp(run, min=0)
        cont_occ = ver_like & (first >= run_valid) & (ext_new < vcap)
        occ_done = ver_like & ~cont_occ
        best_new = torch.where(occ_done, torch.maximum(best_eff, ext_new),
                               best_eff)
        early = best_new >= vcap
        more_occ = occ_done & (occ_i_eff + 1 < cnt_eff) & ~early
        ver_resolve = occ_done & ~more_occ

        # next occurrence: occ 1 inline (occ1c), else the cached quad row
        occ_i2 = torch.where(more_occ, occ_i_eff + 1, occ_i_eff)
        nrow_idx = (aux_eff + occ_i2) >> 2
        from_inline = more_occ & (occ_i2 == 1)
        cached = more_occ & (from_inline | (nrow_idx == prow_eff))
        sel2 = aux_eff + occ_i2
        occ_quad = torch.where(
            (sel2 & 2) == 2,
            torch.where((sel2 & 1) == 1, p3_eff, p2_eff),
            torch.where((sel2 & 1) == 1, p1_eff, p0_eff))
        occ_from_cache = torch.where(from_inline, occ1c_eff, occ_quad)

        # SUB resolution
        bm_word = quad_sel(w_idx)
        bit_set = ((bm_word >> (key_j & 31)) & 1) == 1
        sub_present = is_sub & bit_set
        sub_down = is_sub & ~bit_set
        subj_next = torch.where(sub_down, s["subj"] - 1, s["subj"])
        sub_floor = sub_down & (subj_next <= j0)
        sub_resolve = sub_present | sub_floor

        m_res = torch.where(floor_case & clean, maxlen, torch.where(
            sub_present, s["subj"], torch.where(sub_floor, j0,
                                                k + best_new)))
        m_res = torch.where(ke_present, k - 1,
                            torch.where(ke_floor, j0, m_res))
        resolve = ((floor_case & clean) | sub_resolve | ver_resolve
                   | ke_present | ke_floor)

        # BWD: m == maxlen -> whole prefix occurs, lane done; else go FWD
        b_res = resolve & is_b
        f_res = resolve & ~is_b
        prefix_match = b_res & (m_res == maxlen)
        to_fwd = b_res & ~prefix_match
        b_new = anc - m_res
        # FWD: emit (anc, m + 1) into the staging slots
        e_new = anc + m_res
        emit = f_res
        onehot = (st_iota[None, :] == s["nstage"][:, None]) & emit[:, None]
        s["stage_qs"] = torch.where(onehot, anc[:, None], s["stage_qs"])
        s["stage_l"] = torch.where(onehot, (m_res + 1)[:, None],
                                   s["stage_l"])
        s["nstage"] = torch.where(emit, s["nstage"] + 1, s["nstage"])
        emit_done = emit & (anc == 0)
        anc_restart = anc - 1 if overlap == 0 else e_new + overlap
        restart = emit & ~emit_done

        age2 = torch.where(active, s["age"] + 1, s["age"])
        if budget is not None:
            fb_new = fb_new | (active & (age2 >= budget))
        if work is not None:
            D = torch.minimum(run_valid, run_cap)
            nsym = torch.where(ver_like & (D > 0),
                               torch.where(first < D, first + 1, D), 0)
            work.add_(torch.stack([
                active.sum(), (use_meta | is_sub | is_pos).sum(),
                ver_like.sum(), nsym.sum()]).to(torch.int64))

        active2 = s["active"] & ~(prefix_match | emit_done)
        fb2 = s["fb"] | (fb_new & s["active"])
        mode2 = torch.where(to_fwd | restart, KEY, mode)
        mode2 = torch.where(ke_cont, SUB, mode2)
        mode2 = torch.where(to_sub_short, SUB, mode2)
        mode2 = torch.where(cont_occ, VER, mode2)
        mode2 = torch.where(more_occ & cached, VER, mode2)
        mode2 = torch.where(more_occ & ~cached, POS, mode2)
        s.update(
            active=active2, fb=fb2,
            dirb=torch.where(to_fwd, 0, torch.where(restart, 1, dirb)),
            anc=torch.where(to_fwd, b_new,
                            torch.where(restart, anc_restart, anc)),
            mode=mode2,
            key=torch.where(is_key, key, s["key"]),
            subj=torch.where(ke_cont, k - 2,
                             torch.where(to_sub_short, maxlen, subj_next)),
            cnt=torch.where(use_meta, cnt_k, s["cnt"]),
            aux=torch.where(use_meta, aux_k, s["aux"]),
            occ_i=occ_i2,
            prow=torch.where(more_occ & ~cached, -1, prow_eff),
            p0=p0_eff, p1=p1_eff, p2=p2_eff, p3=p3_eff, occ1c=occ1c_eff,
            occ_pos=torch.where(more_occ & cached, occ_from_cache,
                                torch.where(cont_occ, occ_eff,
                                            s["occ_pos"])),
            ext=torch.where(cont_occ, ext_new,
                            torch.where(ver_like | is_key, 0, s["ext"])),
            best=torch.where(ver_like, best_new,
                             torch.where(is_key, 0, s["best"])),
            age=age2)

    def merge():
        """Drain the staging slots into [Q, cap] in order; a lane past cap
        is flagged overflow and stops."""
        nsfs, nstage = s["nsfs"], s["nstage"]
        idx = nsfs[:, None] + st_iota[None, :]
        ok = (st_iota[None, :] < nstage[:, None]) & (idx < cap)
        idx = torch.where(ok, idx, cap).long()
        out_qs.scatter_(1, idx, torch.where(ok, s["stage_qs"], 0))
        out_l.scatter_(1, idx, torch.where(ok, s["stage_l"], 0))
        overflow = s["overflow"] | (nsfs + nstage > cap)
        s.update(overflow=overflow,
                 nsfs=torch.clamp(nsfs + nstage, max=cap),
                 nstage=torch.zeros_like(nstage),
                 active=s["active"] & ~overflow)

    rounds = 0
    while rounds < max_rounds and bool((s["active"] & ~s["fb"]).any()):
        stage_at = rounds
        while (rounds < max_rounds and rounds < stage_at + STAGE_EVERY
               and bool((s["active"] & ~s["fb"]
                         & (s["nstage"] < STAGE_EVERY)).any())):
            round_body()
            rounds += 1
        merge()
    return PingPongResult(
        qs=out_qs[:, :cap].contiguous(), length=out_l[:, :cap].contiguous(),
        n_sfs=s["nsfs"], overflow=s["overflow"],
        incomplete=s["fb"] | s["active"],
        iters=torch.tensor(rounds, dtype=torch.int32, device=dev))
