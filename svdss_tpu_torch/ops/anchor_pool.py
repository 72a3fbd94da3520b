"""Persistent-lane streaming driver for the anchor-verify engine.

The one-shot `batch_search_anchor` (ops/anchor_device.py) searches a
fixed batch; the pool takes an unbounded stream of reads (`feed`) and
yields each read's result, in completion order, as ``(tag, pairs |
None)`` (`pump`, `drain`), where None means the read needs the exact host
path (unresolvable k-mer window, k-mer above cmax, emission overflow, or
its round budget of 6*len + 64 rounds spent).

On the card one launch of kernel K4 (``csrc/anchor.cu``) searches a chunk
of up to M reads: min(lanes, M) warps, one read each, take the next read
of the chunk from an atomic counter the moment they finish one, so a lane
never idles behind a slower one; `lanes` counts reads in flight, not
threads. The host packs the next chunk into pinned memory and copies it
on a side stream while the launch before it runs. The JAX
package's pool (ops/anchor_pool.py there) keeps a device-side reservoir,
result ring and push/fetch protocol to keep a lockstep TPU loop fed over a
slow host link; one launch per chunk takes their place here.

Each lane machine is independent, so per-read results depend neither on
the lane count nor on scheduling: they equal the JAX pool's, and the
one-shot engine's under the same per-lane budget. On the CPU
`pool_search` runs the plain version: the plain one-shot loop over the
chunk with that budget.

A chunk's host steps are spans of ``svdss_tpu_torch/trace.py``: ``pool:
pack``, ``pool: copy in``, ``pool: launch``, ``pool: wait`` (only when the
oldest chunk has not finished when its results are due), ``pool: fetch``
and ``pool: lists``; the counters ``pool: chunks``, ``pool: reads
launched``, ``pool: flagged overflow`` and ``pool: flagged fallback`` (a
read flagged both ways counts as an overflow) and ``pool: bytes
fetched``.
"""

from __future__ import annotations

from collections import deque
from typing import (Deque, Iterable, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from .. import trace
from .anchor_device import (AnchorParams, DeviceAnchorIndex, WORK_FIELDS,
                            batch_search_anchor_plain, table_args)
from ..utils.device import check_launch, load_kernels, stream_handle
from ..utils.log import logger

launches = 0     # kernel K4 launches since the last reset

FALLBACK, OVERFLOW = 1, 2    # bits of PoolResult.flags


class PoolResult(NamedTuple):
    qs: torch.Tensor          # [M, cap] int32 — query starts, emission order
    length: torch.Tensor      # [M, cap] int32
    n_sfs: torch.Tensor       # [M] int32 (clamped at cap)
    flags: torch.Tensor       # [M] uint8 — FALLBACK | OVERFLOW


def lane_budget(lens: torch.Tensor) -> torch.Tensor:
    """Rounds a read may take before it goes to the host."""
    return 6 * lens + 64


def pack_chunk(encs: List[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """nt6 reads -> (symbols uint8, concatenated; start offsets int64;
    lengths int32)."""
    lens = np.fromiter((len(e) for e in encs), dtype=np.int32,
                       count=len(encs))
    offs = np.zeros(len(encs), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    syms = np.zeros(max(1, int(lens.sum())), dtype=np.uint8)
    for e, o in zip(encs, offs):
        syms[o:o + len(e)] = e
    return syms, offs, lens


def pool_search(index: DeviceAnchorIndex, params: AnchorParams,
                syms: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                Lp1: int, cap: int, overlap: int = -1, lanes: int = 4096,
                work: Optional[torch.Tensor] = None) -> PoolResult:
    """Search one chunk of a pool of padded width Lp1: read i is
    syms[offs[i] : offs[i] + lens[i]], lens[i] <= Lp1 - 1, with a budget
    of 6*lens[i] + 64 rounds. `lanes` bounds the reads in flight on the
    card (results do not depend on it). work: optional int64 [4], as for
    `batch_search_anchor`."""
    M = lens.shape[0]
    if syms.dtype != torch.uint8 or syms.dim() != 1 \
            or offs.dtype != torch.int64 or offs.shape != (M,) \
            or lens.dtype != torch.int32:
        raise TypeError("syms must be uint8 [S], offs int64 [M] and lens "
                        "int32 [M]")
    if work is not None and (work.dtype != torch.int64
                             or work.shape != (len(WORK_FIELDS),)):
        raise TypeError("work must be int64 [4]")
    devs = {t.device for t in (syms, offs, lens, work, index.small)
            if t is not None}
    if len(devs) != 1:
        raise ValueError("index and the chunk must share one device")
    if cap < 1 or lanes < 1:
        raise ValueError("cap and lanes must be >= 1")
    if syms.is_cuda:
        return _launch(index, params, syms.contiguous(), offs.contiguous(),
                       lens.contiguous(), Lp1, cap, overlap, lanes, work)
    return pool_search_plain(index, params, syms, offs, lens, Lp1, cap,
                             overlap, work)


def _launch(index, params, syms, offs, lens, Lp1, cap, overlap, lanes,
            work) -> PoolResult:
    global launches
    M = lens.shape[0]
    dev = syms.device
    bm, targs = table_args(index, params)
    lib = load_kernels()["anchor"]
    out_qs = torch.empty((M, cap), dtype=torch.int32, device=dev)
    out_l = torch.empty((M, cap), dtype=torch.int32, device=dev)
    n_sfs = torch.empty(M, dtype=torch.int32, device=dev)
    flags = torch.empty(M, dtype=torch.uint8, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    rc = lib.svdss_anchor_pool(
        *targs, syms.data_ptr(), offs.data_ptr(), lens.data_ptr(), M, Lp1,
        cap, overlap, lanes, out_qs.data_ptr(), out_l.data_ptr(),
        n_sfs.data_ptr(), flags.data_ptr(), counter.data_ptr(),
        work.data_ptr() if work is not None else None, stream_handle(dev))
    check_launch(rc, "anchor_pool")
    launches += 1
    return PoolResult(out_qs, out_l, n_sfs, flags)


def pool_search_plain(index: DeviceAnchorIndex, params: AnchorParams,
                      syms: torch.Tensor, offs: torch.Tensor,
                      lens: torch.Tensor, Lp1: int, cap: int,
                      overlap: int = -1,
                      work: Optional[torch.Tensor] = None) -> PoolResult:
    """Plain PyTorch version of kernel K4: the chunk padded to [M, Lp1]
    and run through the plain one-shot loop with each lane's budget
    (every lane stops by its budget, so `incomplete` is the fallback
    flag)."""
    M = lens.shape[0]
    dev = syms.device
    seqs = torch.zeros((M, Lp1), dtype=torch.uint8, device=dev)
    if M:
        col = torch.arange(Lp1, device=dev)[None, :]
        valid = col < lens[:, None]
        src = (offs[:, None] + col).clamp(max=syms.shape[0] - 1)
        seqs = torch.where(valid, syms[src], 0).to(torch.uint8)
    budget = lane_budget(lens).to(torch.int32)
    max_rounds = int(budget.max()) if M else 1
    res = batch_search_anchor_plain(index, params, seqs, lens, cap,
                                    max_rounds, overlap, budget, work)
    flags = (res.incomplete.to(torch.uint8) * FALLBACK
             | res.overflow.to(torch.uint8) * OVERFLOW)
    return PoolResult(res.qs, res.length, res.n_sfs, flags)


class AnchorPool:
    """Streams an unbounded read sequence through the anchor engine.

    The streaming API of the JAX package's pool: `feed`, `pump`, `drain`,
    `run`, `queued`, `in_flight`, `occupied`, `M` (reads per chunk: twice
    the lanes, so lanes refill from the chunk as they finish) and `Lp1`
    (padded width). At most two chunks are in flight: one running, the
    next queued behind it on the card. (The JAX pool's `free_slots`, the
    room in its device reservoir, has no counterpart: there is no
    reservoir.) `rounds_run` counts rounds as a pool that runs a warp a
    read can: see its docstring."""

    def __init__(self, index: DeviceAnchorIndex, params: AnchorParams,
                 lanes: int, read_len: int, cap: int = 128,
                 overlap: int = -1):
        self.index = index
        self.params = params
        self.Q = lanes
        self.Lp1 = read_len + 1
        self.cap = cap
        self.overlap = overlap
        self.M = 2 * lanes
        self.device = index.device
        self._queue: Deque[Tuple[object, np.ndarray]] = deque()
        self._flight: Deque = deque()
        self._pushed = 0
        self._done = 0
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._work = torch.zeros(len(WORK_FIELDS), dtype=torch.int64,
                                 device=self.device)
        logger.info("search: anchor pool on %s — %d lanes, chunks of %d "
                    "reads, width %d", self.device, lanes, self.M, read_len)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return self._pushed - self._done

    @property
    def occupied(self) -> int:
        """Reads launched and not yet collected (the JAX pool's reads in
        its lanes and reservoir)."""
        return self.in_flight

    @property
    def rounds_run(self) -> int:
        """Anchor rounds the pool's reads have taken so far, summed over
        every read it launched (the `rounds` field of the work counter,
        ops/anchor_device.py WORK_FIELDS, which each chunk's launch adds
        to). The JAX pool's `rounds_run` counts lockstep steps of its lane
        array, each advancing every lane by one round; here each warp runs
        its reads to their end, so there is no common step to count, and
        the sum over reads is the work that count stood for. Reading it
        waits for the chunks in flight."""
        return int(self._work[0])

    def feed(self, tag: object, enc: np.ndarray) -> None:
        """Queue one nt6 read (len <= read_len) under an opaque tag that
        comes back with its result."""
        if len(enc) > self.Lp1 - 1:
            raise ValueError(f"read of {len(enc)} symbols exceeds the pool "
                             f"width {self.Lp1 - 1}")
        self._queue.append((tag, enc))

    def _launch_chunk(self) -> None:
        m = min(self.M, len(self._queue))
        tags, encs = zip(*(self._queue.popleft() for _ in range(m)))
        with trace.span("pool: pack"):
            host = [torch.from_numpy(a) for a in pack_chunk(list(encs))]
            if self._copy is not None:
                host = [h.pin_memory() for h in host]
        done = None
        if self._copy is not None:
            # pinned, and copied on the side stream: the copy overlaps the
            # launch before it; the compute stream waits for it
            with trace.span("pool: copy in"):
                with torch.cuda.stream(self._copy):
                    chunk = [h.to(self.device, non_blocking=True)
                             for h in host]
                cur = torch.cuda.current_stream(self.device)
                cur.wait_stream(self._copy)
                for t in chunk:
                    t.record_stream(cur)
        else:
            chunk = host
        with trace.span("pool: launch"):
            res = pool_search(self.index, self.params, *chunk, Lp1=self.Lp1,
                              cap=self.cap, overlap=self.overlap,
                              lanes=self.Q, work=self._work)
            if self._copy is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        trace.count("pool: chunks")
        trace.count("pool: reads launched", m)
        self._flight.append((tags, res, done, host))
        self._pushed += m

    def _collect(self, keep: int) -> List:
        """Results of every finished chunk, waiting for the oldest ones
        until at most `keep` chunks are in flight."""
        out: List = []
        while self._flight:
            tags, res, done, _ = self._flight[0]
            ready = done is None or done.query()
            if len(self._flight) <= keep and not ready:
                break
            self._flight.popleft()
            if not ready:
                with trace.span("pool: wait"):
                    done.synchronize()
            with trace.span("pool: fetch"):
                qs, ls, nn, fl = (t.cpu().numpy() for t in res)
            with trace.span("pool: lists"):
                for j, tag in enumerate(tags):
                    n = int(nn[j])
                    out.append((tag, None if fl[j] else list(zip(
                        qs[j, :n].tolist(), ls[j, :n].tolist()))))
            # a read flagged both ways counts as an overflow
            over = (fl & OVERFLOW) != 0
            trace.count("pool: flagged overflow", int(over.sum()))
            trace.count("pool: flagged fallback",
                        int(((fl != 0) & ~over).sum()))
            trace.count("pool: bytes fetched",
                        sum(a.nbytes for a in (qs, ls, nn, fl)))
            self._done += len(tags)
        return out

    def pump(self) -> List[Tuple[object, Optional[List[Tuple[int, int]]]]]:
        """Launch the next chunk of queued reads and return the results
        of the chunks that have finished; with nothing queued, wait for
        every chunk in flight."""
        if self._queue:
            self._launch_chunk()
            return self._collect(keep=1)
        return self._collect(keep=0)

    def drain(self) -> Iterator[Tuple[object,
                                      Optional[List[Tuple[int, int]]]]]:
        """Pump until every queued and launched read has finished."""
        while self._queue or self._flight:
            yield from self.pump()

    def run(self, reads: Iterable[np.ndarray]
            ) -> Iterator[Tuple[int, Optional[List[Tuple[int, int]]]]]:
        """Search a read stream, keeping a chunk queued ahead: yields
        (ordinal in `reads`, pairs | None), in completion order."""
        it = enumerate(reads)
        exhausted = False
        while True:
            while not exhausted and self.queued < self.M:
                nxt = next(it, None)
                if nxt is None:
                    exhausted = True
                else:
                    self.feed(*nxt)
            if exhausted and not self._queue and not self._flight:
                return
            yield from self.pump()
