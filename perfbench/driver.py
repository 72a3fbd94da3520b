"""The window's drivers: the search stage's two read loops, fed in batches.

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

`BucketDriver` is the loop that ``run_search`` runs for every other device
engine: the narrow anchor tables with ``Config.pool`` off (K3), the wide
tables (K5, one shot or in parked-phase waves) and the FM walk (K2). Reads
are bucketed by length, a bucket dispatched to the searcher when it holds
``searcher.lanes_for`` reads with one batch kept in flight, the host redo
of flagged lanes deferred to the searcher's executor and patched in, and
every read emitted in stream order once the input has ended. The reads
handed to one driver are one stream, as a sample is one input to
``run_search``: `hand` buckets and dispatches, and `finish` ends the
input (flush, drain, redo, emit).

`driver_for` picks between them by ``run_search``'s own test.

The loops themselves, the emits and the host redo's schedules, are copies:
``tests/test_pb_driver.py`` holds run_search's source of each to a digest,
so that a change there fails that test until these copies follow.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

MIN_BUCKET = 512     # run_search's smallest length bucket
REDO_AT = 256        # run_search redoes flagged reads in groups this size


def takes_pool(searcher, config) -> bool:
    """run_search's test for its pool branch: narrow anchor tables on the
    device, with Config.pool."""
    return searcher.anchor is not None and not searcher.wide and config.pool


def driver_for(searcher, config):
    """The driver of the loop run_search runs for this searcher."""
    return PoolDriver if takes_pool(searcher, config) else BucketDriver


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
        if not takes_pool(searcher, config):
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

    @property
    def call_s(self) -> float:
        """Host seconds inside the calls into the program's engine."""
        return self.pool_s

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


class BucketDriver:
    """run_search's bucketed one-shot loop over reads handed in batches,
    all of them one stream.

    searcher: a ``pipeline.search._DeviceSearcher`` that did not take the
    pool path; config, keep and span as for `PoolDriver` (span labels the
    wait for the deferred redo and the emit; the searcher's own spans
    label its dispatch and collect). `hand` feeds the stream: reads go to
    their length bucket, and a full bucket is dispatched with one batch
    kept in flight. `finish` ends the stream as run_search ends its input:
    every bucket flushed, the batches drained, the deferred redo patched
    in, the searcher closed and every read emitted in stream order."""

    def __init__(self, searcher, config, keep: Callable[[int], bool],
                 span: Optional[Callable[[str], object]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        from svdss_tpu_torch.models import SFS
        from svdss_tpu_torch.ops.assemble import assemble
        if takes_pool(searcher, config):
            raise ValueError("the searcher takes the pool path "
                             "(narrow anchor tables with Config.pool)")
        self._sfs, self._assemble = SFS, assemble
        self.searcher, self.config, self.keep = searcher, config, keep
        self.span = span or (lambda name: contextlib.nullcontext())
        self.clock = clock
        self.order: List[Tuple[str, int]] = []      # ordinal -> (qname, hp)
        self.redone: List[int] = []
        self._redo_tags: set = set()
        self.done_at: List[float] = []              # nan until emitted
        self.kept: Dict[int, List[Tuple[int, int]]] = {}
        self.pairs_out = 0     # SFS pairs the device engine returned
        self.stray = 0         # answers beyond the batch collected
        self.call_s = 0.0      # host seconds inside dispatch and collect
        self.redo_s = 0.0      # host seconds waiting for the deferred redo
        # run_search's state over its input
        self._buckets: Dict[int, List] = {}
        self._stream: List[Tuple[int, int, int]] = []  # (bucket, idx, tag)
        self._results: Dict[Tuple[int, int], Tuple[int, object]] = {}
        self._flushed: Dict[int, int] = {}
        self._pending: List = []
        self._deferred: List = []    # (bucket, base, redo_idx, future)
        self._counters: Dict[int, int] = {}

    @property
    def nreads(self) -> int:
        return len(self.order)

    def _call(self, fn, *args, **kw):
        t0 = self.clock()
        out = fn(*args, **kw)
        self.call_s += self.clock() - t0
        return out

    # ------------------------------------------------- run_search's loop

    def _drain(self, keep: int = 0) -> None:
        while len(self._pending) > keep:
            bucket, batch, handle = self._pending.pop(0)
            res, d = self._call(self.searcher.collect, handle,
                                defer_redo=True)
            base = self._flushed.get(bucket, 0)
            self.stray += max(0, len(res) - len(batch))
            for k, r in enumerate(res[:len(batch)]):
                self._results[(bucket, base + k)] = (batch[k][0], r)
                self.pairs_out += len(r or ())
            if d is not None:
                self._deferred.append((bucket, base, d[0], d[1]))
            self._flushed[bucket] = base + len(batch)

    def _flush(self, bucket: int) -> None:
        batch = self._buckets.pop(bucket, [])
        if not batch:
            return
        handle = self._call(self.searcher.dispatch, [e for _, e in batch])
        self._pending.append((bucket, batch, handle))
        self._drain(keep=1)   # overlap: keep one batch in flight

    def hand(self, reads: Iterable[Tuple[str, np.ndarray, int]]) -> None:
        """Feed a batch of (qname, nt6 read, hp) to the stream as
        run_search feeds the reads it streams: nothing is emitted before
        `finish`."""
        try:
            for qname, enc, hp in reads:
                b = bucket_len(len(enc))
                idx = self._counters.get(b, 0)
                self._counters[b] = idx + 1
                tag = len(self.order)
                self.order.append((qname, hp))
                self.done_at.append(float("nan"))
                self._buckets.setdefault(b, []).append((tag, enc))
                self._stream.append((b, idx, tag))
                if len(self._buckets[b]) >= self.searcher.lanes_for(b):
                    self._flush(b)
        except BaseException:
            self.searcher.close()
            raise

    def finish(self) -> None:
        """End the stream: flush every bucket, drain, patch the deferred
        redo in, close the searcher, then emit every read in order."""
        try:
            for b in list(self._buckets):
                self._flush(b)
            self._drain(keep=0)
            t0 = self.clock()
            with self.span("search: host redo"):
                for bucket, base, redo_idx, fut in self._deferred:
                    for i, r in zip(redo_idx, fut.result()):
                        key = (bucket, base + i)
                        if key not in self._results:
                            continue      # its answer never came
                        tag, _ = self._results[key]
                        self._results[key] = (tag, r)
                        self.redone.append(tag)
                        self._redo_tags.add(tag)
            self.redo_s += self.clock() - t0
            self._deferred.clear()
        finally:
            self.searcher.close()
        self._emit()

    def _emit(self) -> None:
        """Emit the stream in its order, as run_search does once its input
        has ended. A read whose answer never came stops the stream there
        (run_search fails at it); one whose answer is None (a redo never
        patched in) is not emitted."""
        with self.span("search: emit"):
            for b, idx, tag in self._stream:
                got = self._results.pop((b, idx), None)
                if got is None:
                    break
                _, pairs = got
                if pairs is None:
                    continue
                if pairs:
                    qname, hp = self.order[tag]
                    sfs_list = [self._sfs(qname, q, l, hp) for q, l in pairs]
                    if self.config.assemble:
                        sfs_list = self._assemble(sfs_list)
                    if self.keep(tag) or tag in self._redo_tags:
                        self.kept[tag] = [(s.qs, s.l) for s in sfs_list]
                self.done_at[tag] = self.clock()
        self._stream.clear()
        self._results.clear()

    def lists(self) -> Dict[int, List[Tuple[int, int]]]:
        """The kept reads' merged lists by ordinal, of the reads emitted
        (empty when the read has no SFS: run_search emits nothing for
        it)."""
        return {t: self.kept.get(t, []) for t in range(len(self.order))
                if (self.keep(t) or t in self._redo_tags)
                and not np.isnan(self.done_at[t])}
