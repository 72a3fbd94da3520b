"""Batched ping-pong SFS search on the device (FM rank walk).

Every lane is one read and a small state machine:

    BWD: backward-extend until the current substring is absent or the read
         start is reached;
    FWD: forward-extend from the mismatch until absent again; emit the
         minimal absent substring; restart one base left of its end.

On a CUDA tensor `batch_search` launches kernel K2 (``csrc/pingpong.cu``),
a warp per lane (one launch, Q warps); on a CPU tensor it runs
`batch_search_plain`, the same function as a lockstep loop of tensor ops
over all lanes. Both give
the host oracle's (query_start, length) pairs in emission order for every
lane that is neither `overflow` nor `incomplete`; the host pipeline redoes
those lanes exactly on the host. With the pipeline's overlap (-1) they
also give the JAX package's `pingpong_jax.batch_search` results field for
field. With any other overlap the JAX kernel re-seeds a restart from
P[end - 1] instead of P[begin_new] and leaves the oracle; these follow
the oracle.

A wide table (``DeviceFMDIndex.wide``, n >= 2^31 or forced) runs the same
search with int64 coordinates: the kernel's wide instantiation on the
card, int64 tensors in the plain version.

With a k-mer jump table (``fmd.build_jump_table``, narrow tables only) a
lane whose phase starts on a k-mer present in the table loads that
k-mer's bi-interval and skips k - 1 rank steps, where the JAX package's
`batch_search` with `jump_table`/`keys`/`jump_k` does: the same
transitions jump, decided from the JAX package's per-lane 256-symbol key
chunk, whose base is fixed at the start of each 48-step block. The keys
come from the read itself. Results equal the JAX package's field for
field, except where its zero-padded key chunks hand a lane the key of
poly-A past the padded read: there it jumps and leaves the host oracle,
and these hold no key and follow the oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fmd import DeviceFMDIndex, comp6, extend_rank_step, lookup_C
from ..utils.device import (check_launch, load_kernels, resolve_device,
                            stream_handle)

K_INNER = 48     # steps between overflow checks (the reference's outer body)
CHUNK = 256      # the JAX package's per-lane key chunk (jump mode)
STRIDE = 128     # its base granularity

launches = 0     # kernel K2 launches since the last reset


class PingPongResult(NamedTuple):
    qs: torch.Tensor          # [Q, cap] int32 — query starts, emission order
    length: torch.Tensor      # [Q, cap] int32
    n_sfs: torch.Tensor       # [Q] int32 (clamped at cap)
    overflow: torch.Tensor    # [Q] bool — lane emitted more than cap SFSs
    incomplete: torch.Tensor  # [Q] bool — lane still active at max_iters
    iters: torch.Tensor       # [] int32 — steps run (multiple of 48)


def pack_reads(seq_arrays, pad_to: Optional[int] = None, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a list of nt6 numpy arrays into [Q, L+1] uint8 + lengths [Q]
    int32 on `device` (cuda unless asked otherwise)."""
    dev = resolve_device(device)
    Q = len(seq_arrays)
    L = max((len(s) for s in seq_arrays), default=1)
    if pad_to is not None:
        L = max(L, pad_to)
    out = np.zeros((Q, L + 1), dtype=np.uint8)
    lens = np.zeros(Q, dtype=np.int32)
    for i, s in enumerate(seq_arrays):
        out[i, :len(s)] = s
        lens[i] = len(s)
    seqs, lens = torch.from_numpy(out), torch.from_numpy(lens)
    if dev.type == "cuda":
        # pinned, so the copy queues behind a running batch instead of
        # blocking the host until that batch ends
        return (seqs.pin_memory().to(dev, non_blocking=True),
                lens.pin_memory().to(dev, non_blocking=True))
    return seqs, lens


def batch_search(index: DeviceFMDIndex, seqs: torch.Tensor,
                 lens: torch.Tensor, cap: int = 128, max_iters: int = 0,
                 overlap: int = -1, jump_table=None, jump_k: int = 0,
                 work: Optional[torch.Tensor] = None) -> PingPongResult:
    """Run ping-pong search over a padded read batch.

    seqs: [Q, L+1] uint8 nt6 symbols, 0-padded past each read's length.
    lens: [Q] int32 read lengths. max_iters=0 means 8*L + 64 steps.
    jump_table/jump_k: the k-mer jump-start, with the int32 [4^jump_k, 4]
    table of ``fmd.build_jump_table`` (narrow tables only).
    work: optional int64 tensor of one or two counters, to which the rank
    steps the batch took and (second) the jump-table rows it read are
    added (a measurement aid; the results do not depend on it)."""
    Q, Lp1 = seqs.shape
    if (jump_table is None) != (jump_k == 0):
        raise ValueError("jump_table and jump_k > 0 go together")
    if jump_k:
        if index.wide:
            raise ValueError("k-mer jump tables are narrow-mode only")
        if (not 1 <= jump_k <= 15 or jump_table.dtype != torch.int32
                or jump_table.shape != (4 ** jump_k, 4)
                or not jump_table.is_contiguous()
                or jump_table.device != index.device):
            raise TypeError("jump_table must be a contiguous int32 "
                            "[4^jump_k, 4] table on the index's device, "
                            "1 <= jump_k <= 15")
    if seqs.dtype != torch.uint8 or lens.dtype != torch.int32 \
            or lens.shape != (Q,):
        raise TypeError("seqs must be uint8 [Q, L+1] and lens int32 [Q]")
    if not (seqs.device == lens.device == index.device):
        raise ValueError("index, seqs and lens must share one device")
    if cap < 1:
        raise ValueError("cap must be >= 1")
    if max_iters == 0:
        max_iters = 8 * (Lp1 - 1) + 64
    max_outer = (max_iters + K_INNER - 1) // K_INNER
    if work is not None and (work.dtype != torch.int64 or work.dim() != 1
                             or not 1 <= work.numel() <= 2
                             or work.device != seqs.device):
        raise TypeError("work must be an int64 [1] or [2] tensor on the "
                        "seqs device")
    if seqs.is_cuda:
        return _launch(index, seqs.contiguous(), lens.contiguous(), cap,
                       max_outer, overlap, jump_table, jump_k, work)
    return batch_search_plain(index, seqs, lens, cap, max_outer, overlap,
                              work, jump_table, jump_k)


def n_windows(Lp1: int) -> int:
    """The number of 256-symbol key chunks (at stride 128) the JAX package
    cuts a [Q, Lp1] batch into (`pingpong_jax._build_chunks`)."""
    w = ((Lp1 + STRIDE - 1) // STRIDE + 2) * STRIDE
    return 2 * (-(-w // CHUNK)) - 1


def _launch(index, seqs, lens, cap, max_outer, overlap, jump_table, jump_k,
            work):
    global launches
    Q, Lp1 = seqs.shape
    dev = seqs.device
    c_type = torch.int64 if index.wide else torch.int32
    if (index.fused.dtype != torch.int32 or index.fused.dim() != 2
            or index.fused.shape[1] != 48 or not index.fused.is_contiguous()
            or index.C.dtype != c_type or index.C.shape != (8,)):
        raise TypeError("index must hold a contiguous int32 [nblk, 48] "
                        "table and an [8] C (int32, int64 if wide)")
    lib = load_kernels()["pingpong"]
    out_qs = torch.empty((Q, cap), dtype=torch.int32, device=dev)
    out_l = torch.empty((Q, cap), dtype=torch.int32, device=dev)
    n_sfs = torch.empty(Q, dtype=torch.int32, device=dev)
    overflow = torch.empty(Q, dtype=torch.bool, device=dev)
    incomplete = torch.empty(Q, dtype=torch.bool, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    rc = lib.svdss_pingpong_fm(
        index.fused.data_ptr(), index.C.data_ptr(), seqs.data_ptr(),
        lens.data_ptr(),
        jump_table.data_ptr() if jump_table is not None else None, Q, Lp1,
        cap, max_outer, overlap, index.limb_bits or 0, jump_k,
        n_windows(Lp1), out_qs.data_ptr(), out_l.data_ptr(),
        n_sfs.data_ptr(), overflow.data_ptr(), incomplete.data_ptr(),
        iters.data_ptr(), work.data_ptr() if work is not None else None,
        work[1:].data_ptr() if work is not None and work.numel() > 1
        else None, stream_handle(dev))
    check_launch(rc, "pingpong_fm")
    launches += 1
    return PingPongResult(out_qs, out_l, n_sfs, overflow, incomplete, iters)


def window_keys(P: torch.Tensor, lane: torch.Tensor, kpos: torch.Tensor,
                k: int) -> torch.Tensor:
    """Per lane, the key of the k-mer of P[lane] ending at kpos (sum
    (sym - 1) * 4^i, the last symbol at 4^0), or -1 when the window starts
    before the read, ends past the padded read, or holds a symbol outside
    A..T."""
    Lp1 = P.shape[1]
    at = kpos[:, None] - torch.arange(k, device=P.device,
                                      dtype=torch.int32)[None, :]
    inside = (at >= 0) & (at < Lp1)
    s = P[lane[:, None], at.clamp(0, Lp1 - 1).long()]
    ok = (inside & (s >= 1) & (s <= 4)).all(dim=1)
    key = ((s - 1) << (2 * torch.arange(k, device=P.device,
                                        dtype=torch.int32))).sum(
        dim=1, dtype=torch.int32)
    return torch.where(ok, key, -1)


def batch_search_plain(index: DeviceFMDIndex, seqs: torch.Tensor,
                       lens: torch.Tensor, cap: int, max_outer: int,
                       overlap: int = -1,
                       work: Optional[torch.Tensor] = None,
                       jump_table: Optional[torch.Tensor] = None,
                       jump_k: int = 0) -> PingPongResult:
    """Plain PyTorch version of kernel K2: all lanes advance in lockstep,
    one step per iteration, overflow checked every 48 steps. Coordinates
    are int64 on a wide table. With jump_table/jump_k, the jump mode.

    The lane state lives in fixed tensors that each step updates in place,
    so on a CUDA tensor every step after the first replays one captured
    CUDA graph of the step's ops (the step is a few hundred small ops, and
    launching them one by one would take minutes at the search stage's
    read lengths)."""
    dev = seqs.device
    Q, Lp1 = seqs.shape
    P = seqs.to(torch.int32)
    lane = torch.arange(Q, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    begin0 = lens - 1
    c0 = P[lane, begin0.clamp(min=0).long()]
    pos0 = lookup_C(index, c0)
    s = dict(dir=torch.zeros(Q, **i32), begin=begin0,
             end=torch.zeros(Q, **i32), pos=pos0,
             sz=lookup_C(index, c0 + 1) - pos0, active=lens >= 1,
             pend=torch.zeros(Q, dtype=torch.bool, device=dev),
             p_rank=torch.zeros(Q, dtype=index.C.dtype, device=dev),
             count=torch.zeros(Q, **i32), base=torch.zeros(Q, **i32))
    out_qs = torch.zeros((Q, cap), **i32)
    out_l = torch.zeros((Q, cap), **i32)
    overflow = torch.zeros(Q, dtype=torch.bool, device=dev)

    def step():
        dir_, begin, end, pos, sz, active, pend, p_rank, count = (
            s[k] for k in ("dir", "begin", "end", "pos", "sz", "active",
                           "pend", "p_rank", "count"))
        is_bwd = dir_ == 0
        bwd_can = is_bwd & (sz != 0) & (begin > 0)
        fwd_can = ~is_bwd & (sz != 0)
        do_ext = active & (bwd_can | fwd_can)
        a = torch.where(is_bwd, torch.where(bwd_can, begin - 1, begin),
                        torch.where(fwd_can, end + 1, end - 1))
        a = a.clamp(min=0)
        c_acc = torch.where(a < Lp1, P[lane, a.clamp(max=Lp1 - 1).long()], 0)
        c_sel = torch.where(is_bwd, c_acc, comp6(c_acc))
        sent = ~is_bwd & (c_acc == 0)
        do_rank = do_ext & ~sent
        if work is not None:
            work[:1] += do_rank.sum()
        posn, szn, complete, pend, p_rank = extend_rank_step(
            index, pos, sz, c_sel, do_rank, pend, p_rank)
        szn = torch.where(sent, 0, szn)
        complete = complete | sent
        do_apply = do_ext & complete
        upd_b = active & bwd_can & complete
        upd_f = active & fwd_can & complete
        b_exit = active & is_bwd & ~bwd_can
        f_exit = active & ~is_bwd & ~fwd_can
        begin1 = torch.where(upd_b, begin - 1, begin)
        end1 = torch.where(upd_f, end + 1, end)
        pos = torch.where(do_apply, posn, pos)
        sz1 = torch.where(do_apply, szn, sz)
        prefix_match = b_exit & (begin == 0) & (sz != 0)
        to_fwd = b_exit & ~prefix_match
        # emit (begin, end - begin + 1) while below cap (a masked write to
        # each lane's next slot: no host sync, unlike a boolean index)
        w = f_exit & (count < cap)
        slot = count.clamp(max=cap - 1).long()
        out_qs[lane, slot] = torch.where(w, begin1, out_qs[lane, slot])
        out_l[lane, slot] = torch.where(w, end1 - begin1 + 1,
                                        out_l[lane, slot])
        count = count + f_exit.to(torch.int32)
        emit_done = f_exit & (begin1 == 0)
        begin_new = begin1 - 1 if overlap == 0 else end1 + overlap
        restart = f_exit & ~emit_done
        trans = to_fwd | restart
        # re-seed from one symbol: P[begin] (= c_acc) going forward,
        # P[begin_new] going backward
        c_t = torch.where(to_fwd, c_acc, torch.where(
            (begin_new >= 0) & (begin_new < Lp1),
            P[lane, begin_new.clamp(0, Lp1 - 1).long()], 0))
        post_t = lookup_C(index, torch.where(to_fwd, comp6(c_t), c_t))
        szt = lookup_C(index, c_t + 1) - lookup_C(index, c_t)
        hit = torch.zeros_like(trans)
        if jump_k:
            # jump where the whole post-jump drift of the block stays in
            # the JAX package's chunk (safe_b, safe_f)
            kpos = torch.where(restart, begin_new, begin1 + jump_k - 1)
            koff = kpos - s["base"]
            safe_b = (koff >= jump_k + K_INNER) & (koff < CHUNK) & (
                begin_new >= jump_k - 1)
            safe_f = (koff >= 0) & (koff + K_INNER + 1 < CHUNK)
            key = window_keys(P, lane, kpos, jump_k)
            cand = ((restart & safe_b) | (to_fwd & safe_f)) & (key >= 0)
            if work is not None and work.numel() > 1:
                work[1:] += cand.sum()
            row = jump_table[key.clamp(min=0).long()]
            hit = cand & (row[:, 2] > 0)
            post_t = torch.where(hit, torch.where(to_fwd, row[:, 1],
                                                  row[:, 0]), post_t)
            szt = torch.where(hit, row[:, 2], szt)
        new = dict(
            dir=torch.where(to_fwd, 1, torch.where(restart, 0, dir_)),
            end=torch.where(to_fwd, torch.where(
                hit, begin1 + (jump_k - 1), begin1), end1),
            begin=torch.where(restart, torch.where(
                hit, begin_new - (jump_k - 1), begin_new), begin1),
            pos=torch.where(trans, post_t, pos),
            sz=torch.where(trans, szt, sz1),
            active=active & ~(prefix_match | emit_done),
            pend=pend, p_rank=p_rank, count=count)
        for k, v in new.items():
            s[k].copy_(v)

    graph = None
    it = 0
    while it < max_outer * K_INNER and bool(s["active"].any()):
        if jump_k:
            # each lane's key-chunk base for this block (pingpong_jax.py
            # :316-319, 328)
            cursor = torch.where(s["dir"] == 0, s["begin"],
                                 s["end"] + 1).clamp(0, Lp1 - 1)
            s["base"].copy_(((cursor - STRIDE // 2) >> 7).clamp(
                0, n_windows(Lp1) - 1) * STRIDE)
        for _ in range(K_INNER):
            if graph is not None:
                graph.replay()
            else:
                step()
                if dev.type == "cuda":
                    # the first step ran eagerly (the warm-up); capture the
                    # next, which replays for every later step
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        step()
        it += K_INNER
        overflow |= s["count"] > cap
        s["active"] &= ~overflow
    del graph
    return PingPongResult(
        qs=out_qs, length=out_l, n_sfs=s["count"].clamp(max=cap),
        overflow=overflow, incomplete=s["active"],
        iters=torch.tensor(it, dtype=torch.int32, device=dev))
