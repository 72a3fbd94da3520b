"""The window's driver: the search stage's pool loop, fed in batches.

`PoolDriver` is the loop that ``pipeline/search.py`` ``run_search`` runs
for narrow anchor tables with ``Config.pool`` (the default of ``cli run``
from 2^26 symbols), in its order and with the program's public classes:
one ``AnchorPool`` over the searcher's device tables, recreated at a wider
shape when a longer length bucket appears (after draining the narrower
one); a read is fed under its ordinal, the pool pumped whenever a chunk is
queued, finished reads absorbed, flagged reads (None) collected for the
searcher's host engine and redone 256 at a time, and every read emitted in
stream order as SFS records, merged by ``assemble``. What differs is
bookkeeping only: reads come as batches that the caller hands in
(`hand`) instead of from a BAM, nothing is written to a file, and each
read's completion time is kept (when it is emitted: its merged list made,
in stream order, after every read before it), with the host seconds spent
inside the pool's calls and the redo.

The loop itself, the emit and the host redo's schedule of 256 reads, is a
copy: ``tests/test_pb_driver.py`` holds run_search's source of it to a
digest, so that a change there fails that test until this copy follows.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

MIN_BUCKET = 512     # run_search's smallest length bucket
REDO_AT = 256        # run_search redoes flagged reads in groups this size


def bucket_len(n: int) -> int:
    """run_search's length bucket: 512 doubled until it holds n."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


class PoolDriver:
    """run_search's pool loop over reads handed in batches.

    searcher: a ``pipeline.search._DeviceSearcher`` that took the narrow
    anchor engine; config: its ``Config``; keep(ordinal) says which reads'
    merged lists to keep (reads sent to the host redo are kept too);
    span(name) is a context manager around each call into the pool and the
    redo (a trace label, or none)."""

    def __init__(self, searcher, config, keep: Callable[[int], bool],
                 span: Optional[Callable[[str], object]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        from svdss_tpu_torch.models import SFS
        from svdss_tpu_torch.ops.anchor_pool import AnchorPool
        from svdss_tpu_torch.ops.assemble import assemble
        from svdss_tpu_torch.pipeline import search
        if searcher.anchor is None or searcher.wide or not config.pool:
            raise ValueError("the searcher did not take the pool path "
                             "(narrow anchor tables with Config.pool)")
        self._pool_cls, self._sfs, self._assemble = AnchorPool, SFS, assemble
        self._search = search
        self.searcher, self.config, self.keep = searcher, config, keep
        self.span = span or (lambda name: contextlib.nullcontext())
        self.clock = clock
        self.pool = None
        self.pools: List = []          # every pool made, in order
        self.order: List[Tuple[str, int]] = []      # ordinal -> (qname, hp)
        self.results: Dict[int, List[Tuple[int, int]]] = {}
        self.encs: Dict[int, np.ndarray] = {}       # in flight and redo
        self.redo: List[int] = []
        self.redone: List[int] = []
        self._redo_tags: set = set()     # redone, for keeping their lists
        self._waiting: set = set()       # flagged, waiting for the redo
        self.emitted = 0
        self.done_at: List[float] = []              # nan until finished
        self.kept: Dict[int, List[Tuple[int, int]]] = {}
        self.pairs_out = 0     # SFS pairs the pool returned
        self.stray = 0         # answers for reads not in flight
        self.pool_s = 0.0      # host seconds inside the pool's calls
        self.redo_s = 0.0      # host seconds inside the host redo

    @property
    def nreads(self) -> int:
        return len(self.order)

    # ------------------------------------------------------- pool calls

    def _call(self, name: str, fn, *args):
        t0 = self.clock()
        with self.span(name):
            out = fn(*args)
        self.pool_s += self.clock() - t0
        return out

    def _drained(self):
        """The pool's drain, timed and labelled call by call."""
        it = self.pool.drain()
        while True:
            t0 = self.clock()
            with self.span("pool: drain"):
                item = next(it, None)
            self.pool_s += self.clock() - t0
            if item is None:
                return
            yield item

    # ------------------------------------------------- run_search's loop

    def _flush_redo(self) -> None:
        if not self.redo:
            return
        t0 = self.clock()
        with self.span("search: host redo"):
            res = self._search.host_search_batch(
                self.searcher.index, [self.encs.pop(i) for i in self.redo],
                self.config.overlap, self.config.threads)
        self.redo_s += self.clock() - t0
        for i, r in zip(self.redo, res):
            self.results[i] = r
        self.redone.extend(self.redo)
        self._redo_tags.update(self.redo)
        self._waiting.clear()
        self.redo.clear()

    def _emit_ready(self) -> None:
        """Emit the finished prefix in stream order, as run_search does."""
        with self.span("search: emit"):
            while self.emitted in self.results:
                tag = self.emitted
                self.emitted += 1
                qname, hp = self.order[tag]
                pairs = self.results.pop(tag)
                if pairs:
                    sfs_list = [self._sfs(qname, q, l, hp) for q, l in pairs]
                    if self.config.assemble:
                        sfs_list = self._assemble(sfs_list)
                    if self.keep(tag) or tag in self._redo_tags:
                        self.kept[tag] = [(s.qs, s.l) for s in sfs_list]
                self.done_at[tag] = self.clock()

    def _absorb(self, done: Iterable) -> None:
        for tag, pairs in done:
            if tag not in self.encs or tag in self._waiting:
                # an answer for a read not in flight: counted, not taken
                self.stray += 1
                continue
            if pairs is None:
                self.searcher.fallbacks += 1
                self.redo.append(tag)
                self._waiting.add(tag)
            else:
                self.results[tag] = pairs
                self.pairs_out += len(pairs)
                del self.encs[tag]
            self.searcher.device_reads += 1
        if len(self.redo) >= REDO_AT:
            self._flush_redo()
        self._emit_ready()

    def hand(self, reads: Iterable[Tuple[str, np.ndarray, int]]) -> None:
        """Feed a batch of (qname, nt6 read, hp) as run_search feeds the
        reads it streams."""
        for qname, enc, hp in reads:
            b = bucket_len(len(enc))
            if self.pool is None or b > self.pool.Lp1 - 1:
                if self.pool is not None:
                    self._absorb(self._drained())
                self.pool = self._call(
                    "pool: create", self._pool_cls, self.searcher.anchor,
                    self.searcher.anchor_params, self.config.lanes, b,
                    self.searcher.cap, self.config.overlap)
                self.pools.append(self.pool)
            tag = len(self.order)
            self.order.append((qname, hp))
            self.done_at.append(float("nan"))
            self.encs[tag] = enc
            t0 = self.clock()
            self.pool.feed(tag, enc)
            self.pool_s += self.clock() - t0
            if self.pool.queued >= self.pool.M:
                self._absorb(self._call("pool: pump", self.pool.pump))

    def finish(self) -> None:
        """Drain the pool, redo what is left and emit the rest."""
        if self.pool is not None:
            self._absorb(self._drained())
        self._flush_redo()
        self._emit_ready()

    def lists(self) -> Dict[int, List[Tuple[int, int]]]:
        """The kept reads' merged lists by ordinal (empty when the read
        has no SFS: run_search emits nothing for it)."""
        return {t: self.kept.get(t, []) for t in range(self.emitted)
                if self.keep(t) or t in self._redo_tags}
