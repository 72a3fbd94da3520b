"""Batched ping-pong SFS search on the device (FM rank walk, narrow mode).

Every lane is one read and a small state machine:

    BWD: backward-extend until the current substring is absent or the read
         start is reached;
    FWD: forward-extend from the mismatch until absent again; emit the
         minimal absent substring; restart one base left of its end.

On a CUDA tensor `batch_search` launches kernel K2 (``csrc/pingpong.cu``),
one thread per lane; on a CPU tensor it runs `batch_search_plain`, the
same function as a lockstep loop of tensor ops over all lanes. Both give
the host oracle's (query_start, length) pairs in emission order for every
lane that is neither `overflow` nor `incomplete`; the host pipeline redoes
those lanes exactly on the host. With the pipeline's overlap (-1) they
also give the JAX package's `pingpong_jax.batch_search` results field for
field. With any other overlap the JAX kernel re-seeds a restart from
P[end - 1] instead of P[begin_new] and leaves the oracle; these follow
the oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fmd import DeviceFMDIndex, comp6, extend_rank_step, lookup_C
from ..utils.device import (check_launch, load_kernels, resolve_device,
                            stream_handle)

K_INNER = 48     # steps between overflow checks (the reference's outer body)

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
    work: optional int64 [1] tensor to which the number of rank steps the
    batch took is added (a measurement aid; the results do not depend on
    it)."""
    if jump_table is not None or jump_k:
        raise NotImplementedError("the k-mer jump table is not ported yet")
    Q, Lp1 = seqs.shape
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
    if seqs.is_cuda:
        return _launch(index, seqs.contiguous(), lens.contiguous(), cap,
                       max_outer, overlap, work)
    return batch_search_plain(index, seqs, lens, cap, max_outer, overlap,
                              work)


def _launch(index, seqs, lens, cap, max_outer, overlap, work):
    global launches
    Q, Lp1 = seqs.shape
    dev = seqs.device
    if work is not None and (work.dtype != torch.int64
                             or work.device != dev):
        raise TypeError("work must be an int64 tensor on the seqs device")
    if (index.fused.dtype != torch.int32 or index.fused.dim() != 2
            or index.fused.shape[1] != 48 or not index.fused.is_contiguous()
            or index.C.dtype != torch.int32 or index.C.shape != (8,)):
        raise TypeError("index must hold a contiguous int32 [nblk, 48] "
                        "table and an int32 [8] C")
    lib = load_kernels()["pingpong"]
    out_qs = torch.empty((Q, cap), dtype=torch.int32, device=dev)
    out_l = torch.empty((Q, cap), dtype=torch.int32, device=dev)
    n_sfs = torch.empty(Q, dtype=torch.int32, device=dev)
    overflow = torch.empty(Q, dtype=torch.bool, device=dev)
    incomplete = torch.empty(Q, dtype=torch.bool, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    rc = lib.svdss_pingpong_fm(
        index.fused.data_ptr(), index.C.data_ptr(), seqs.data_ptr(),
        lens.data_ptr(), Q, Lp1, cap, max_outer, overlap,
        out_qs.data_ptr(), out_l.data_ptr(), n_sfs.data_ptr(),
        overflow.data_ptr(), incomplete.data_ptr(), iters.data_ptr(),
        work.data_ptr() if work is not None else None, stream_handle(dev))
    check_launch(rc, "pingpong_fm")
    launches += 1
    return PingPongResult(out_qs, out_l, n_sfs, overflow, incomplete, iters)


def batch_search_plain(index: DeviceFMDIndex, seqs: torch.Tensor,
                       lens: torch.Tensor, cap: int, max_outer: int,
                       overlap: int = -1,
                       work: Optional[torch.Tensor] = None
                       ) -> PingPongResult:
    """Plain PyTorch version of kernel K2: all lanes advance in lockstep,
    one step per iteration, overflow checked every 48 steps."""
    dev = seqs.device
    Q, Lp1 = seqs.shape
    P = seqs.to(torch.int32)
    lane = torch.arange(Q, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    begin = lens - 1
    c0 = P[lane, begin.clamp(min=0).long()]
    pos = lookup_C(index, c0)
    sz = lookup_C(index, c0 + 1) - pos
    dir_ = torch.zeros(Q, **i32)
    end = torch.zeros(Q, **i32)
    active = lens >= 1
    pend = torch.zeros(Q, dtype=torch.bool, device=dev)
    p_rank = torch.zeros(Q, **i32)
    count = torch.zeros(Q, **i32)
    out_qs = torch.zeros((Q, cap), **i32)
    out_l = torch.zeros((Q, cap), **i32)
    overflow = torch.zeros(Q, dtype=torch.bool, device=dev)
    it = 0
    while it < max_outer * K_INNER and bool(active.any()):
        for _ in range(K_INNER):
            is_bwd = dir_ == 0
            bwd_can = is_bwd & (sz != 0) & (begin > 0)
            fwd_can = ~is_bwd & (sz != 0)
            do_ext = active & (bwd_can | fwd_can)
            a = torch.where(is_bwd, torch.where(bwd_can, begin - 1, begin),
                            torch.where(fwd_can, end + 1, end - 1))
            a = a.clamp(min=0)
            c_acc = torch.where(a < Lp1,
                                P[lane, a.clamp(max=Lp1 - 1).long()], 0)
            c_sel = torch.where(is_bwd, c_acc, comp6(c_acc))
            sent = ~is_bwd & (c_acc == 0)
            do_rank = do_ext & ~sent
            if work is not None:
                work += do_rank.sum()
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
            # emit (begin, end - begin + 1) while below cap (a masked write
            # to each lane's next slot: no host sync, unlike a boolean index)
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
            dir_ = torch.where(to_fwd, 1, torch.where(restart, 0, dir_))
            end = torch.where(to_fwd, begin1, end1)
            begin = torch.where(restart, begin_new, begin1)
            pos = torch.where(trans, post_t, pos)
            sz = torch.where(trans, szt, sz1)
            active = active & ~(prefix_match | emit_done)
        it += K_INNER
        overflow = overflow | (count > cap)
        active = active & ~overflow
    return PingPongResult(
        qs=out_qs, length=out_l, n_sfs=count.clamp(max=cap),
        overflow=overflow, incomplete=active,
        iters=torch.tensor(it, dtype=torch.int32, device=dev))
