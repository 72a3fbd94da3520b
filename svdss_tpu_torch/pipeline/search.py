"""``search`` stage: extract sample-specific strings from reads.

Pipeline equivalent of ``PingPong::search`` (ping_pong.cpp:239-397), rebuilt
around the batched device kernel:

  * stream the (smoothed) BAM, keeping primary alignments with
    l_qseq >= 100 and (by default) XF == 0 — the same eligibility rules as
    load_batch_bam/process_batch (ping_pong.cpp:66-79, 196-203);
  * encode reads to nt6 and search them on the device with one of three
    engines: the FM rank walk (ops/pingpong.py, kernel K2 on the card,
    wide mode past 2^31 symbols; with ``Config.kmer_jump`` from 2^22
    symbols, jump-started from a k-mer table built by kernel K6) in
    length-bucketed lane batches, the narrow anchor-verify engine
    (ops/anchor_device.py) — one-shot batches
    (kernel K3) or the persistent-lane pool (ops/anchor_pool.py, kernel
    K4) — or the wide anchor engine over forward-strand tables
    (ops/anchor_wide_device.py, kernel K5: parked-phase waves when the
    tables carry a heavy store, else one-shot batches), chosen as the JAX
    package chooses; any lane that overflows its emission buffer or needs
    the exact path is redone on the host, so output is exact either way;
  * optionally merge overlapping SFSs per read (ops/assemble.py, on by
    default like ``--noassemble``'s inverse) and write the 4-column
    specifics.txt.

Output records appear in BAM order (the reference emits a thread-count-
dependent per-batch lexicographic permutation, ping_pong.cpp:213-236 with
``map<string, vector<SFS>>``; downstream parses the file into a map keyed by
read name, so ordering is immaterial — documented deviation).
"""

from __future__ import annotations

import resource
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..index.fmd import FMDIndex
from ..io.bam import BamReader
from ..io.sfs_file import write_sfs_file
from ..models import SFS
from ..ops.anchor_device import batch_search_anchor, build_device_anchor
from ..ops.anchor_pool import AnchorPool
from ..ops.anchor_wide import AnchorIndexWide, make_heavy_resolver
from ..ops.anchor_wide_device import (WideWaveRun, batch_search_anchor_wide,
                                      build_device_anchor_wide)
from ..ops.assemble import assemble
from ..ops.fmd import DeviceFMDIndex, build_jump_table
from ..ops.pingpong import batch_search, pack_reads
from ..ops.pingpong_host import ping_pong_search
from ..utils.device import resolve_device
from ..utils.seq import encode_nt6
from ..utils.log import logger

MIN_READ_LEN = 100   # ping_pong.cpp:70
_MIN_BUCKET = 512

_NATIVE_FMD_CACHE: dict = {}


def host_search_batch(index: FMDIndex, encoded: List[np.ndarray],
                      overlap: int = -1, threads: int = 2
                      ) -> List[List[Tuple[int, int]]]:
    """Host-path search for a batch: the native threaded engine
    (ops/pingpong_native.py — the reference's 16-thread CPU role,
    ping_pong.cpp:329) when built, else the Python oracle. Exact either
    way; used by --no-device runs and the device-overflow fallback."""
    key = id(index)
    nf = _NATIVE_FMD_CACHE.get(key)
    if nf is None and key not in _NATIVE_FMD_CACHE:
        from ..ops.pingpong_native import open_native_fmd
        nf = open_native_fmd(index, threads)
        _NATIVE_FMD_CACHE.clear()     # one live index at a time
        _NATIVE_FMD_CACHE[key] = nf
    if nf is not None:
        return nf.search_batch(encoded, overlap, threads)
    return [ping_pong_search(index, e, overlap) for e in encoded]


def _prefetch(iterable, maxsize: int = 8192):
    """Run the read iterator in a background thread (the role of the
    reference's load-lane in its double-buffered OpenMP pipeline,
    ping_pong.cpp:325-380): BAM decode overlaps device batches."""
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    sentinel = object()
    error = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as exc:  # propagate to consumer
            error.append(exc)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item


def _bucket_len(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def eligible_reads_bam(bam_path: str, putative: bool
                       ) -> Iterator[Tuple[str, str, int]]:
    """(qname, seq, hp_tag) for reads the search should process."""
    with BamReader(bam_path) as reader:
        for rec in reader:
            if not rec.is_primary:
                continue
            if rec.l_seq < MIN_READ_LEN:
                continue
            xf = rec.get_tag("XF", 0)
            if putative and xf != 0:
                continue
            hp = rec.get_tag("HP", 0) or 0
            yield rec.qname, rec.seq, int(hp)


def eligible_reads_bam_native(bam_path: str, putative: bool):
    """Native fast path for the search stage's read extraction:
    parallel BGZF inflate + one C pass for eligibility / XF / HP aux
    tags / nt6 sequence decode (native/bamio.cpp svdss_search_scan +
    svdss_search_extract). The Python per-record parse fed the device
    at a few hundred reads/s on whole-genome BAMs — the 1 Gbp
    end-to-end's search stage was input-bound on it. Yields (qname,
    nt6 uint8 array, hp); returns None when the library is absent
    (callers fall back to eligible_reads_bam)."""
    import ctypes
    from ..io import native as nat
    lib = nat.load()
    if lib is None or not hasattr(lib, "svdss_search_scan"):
        return None
    data = nat.bgzf_read_all(bam_path)
    if data is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    P64 = ctypes.POINTER(ctypes.c_int64)
    recsp = ctypes.c_void_p()
    nrecs = ctypes.c_int64()
    if lib.svdss_bam_scan(buf.ctypes.data, len(buf),
                          ctypes.byref(recsp),
                          ctypes.byref(nrecs)) != 0:
        return None
    n = int(nrecs.value)
    try:
        recs = np.ctypeslib.as_array(
            ctypes.cast(recsp, P64), shape=(max(n, 1), 8))[:n].copy()
    finally:
        lib.svdss_free(recsp)

    def gen():
        elig = np.zeros(n, dtype=np.uint8)
        xf = np.zeros(n, dtype=np.int32)
        hp = np.zeros(n, dtype=np.int32)
        if n:
            lib.svdss_search_scan(
                buf.ctypes.data, recs.ctypes.data, n, MIN_READ_LEN,
                1 if putative else 0, elig.ctypes.data,
                xf.ctypes.data, hp.ctypes.data)
        offs = recs[:, 0]
        l_seq = recs[:, 6]
        lrn = buf[np.minimum(offs + 8, len(buf) - 1)].astype(np.int64)
        CH = 65536               # records per extraction chunk
        for lo in range(0, n, CH):
            hi = min(n, lo + CH)
            e = elig[lo:hi].astype(bool)
            if not e.any():
                continue
            ls = np.where(e, l_seq[lo:hi], 0)
            starts = np.zeros(hi - lo, dtype=np.int64)
            np.cumsum(ls[:-1], out=starts[1:])
            out = np.empty(int(ls.sum()), dtype=np.uint8)
            lib.svdss_search_extract(
                buf.ctypes.data, recs[lo:hi].ctypes.data, hi - lo,
                np.ascontiguousarray(elig[lo:hi]).ctypes.data,
                starts.ctypes.data, out.ctypes.data)
            for i in np.nonzero(e)[0]:
                gi = lo + int(i)
                o = int(offs[gi])
                qname = buf[o + 32:o + 32 + int(lrn[gi]) - 1] \
                    .tobytes().decode()
                s0 = int(starts[i])
                yield (qname, out[s0:s0 + int(l_seq[gi])],
                       int(hp[gi]))

    return gen()


def eligible_reads_fastx(path: str) -> Iterator[Tuple[str, str, int]]:
    """FASTA/FASTQ input (no filters, hp=0), cf. load_batch_fastq."""
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        first = fh.read(1)
        fh.seek(0)
        if first == ">":
            name, seq = None, []
            for line in fh:
                line = line.rstrip()
                if line.startswith(">"):
                    if name:
                        yield name, "".join(seq), 0
                    name, seq = line[1:].split()[0], []
                else:
                    seq.append(line)
            if name:
                yield name, "".join(seq), 0
        else:
            while True:
                h = fh.readline()
                if not h:
                    break
                s = fh.readline().rstrip()
                fh.readline()
                fh.readline()
                yield h[1:].split()[0], s, 0


def wide_engine_cost(anchor):
    """Gather-cost estimates (anchor_gathers_per_phase, fm_gathers_per
    _phase, pw_depth) for the wide-engine-vs-FM routing decision, as the
    JAX package computes them (its constants were calibrated on the TPU:
    the port reproduces the decision, not the tuning). Per phase the
    anchor engine pays the 3-gather KEY chain plus ~2*log2(depth) probe
    gathers per orientation on right-sorted buckets (linear ~1.5*depth for
    orientation B on right-order-only tables) plus a parked-wave surcharge
    on heavy phases; depth is the POSITION-WEIGHTED kept-bucket size. The
    FM walk pays ~2 gathers per matched symbol."""
    import math
    kept = anchor.aux != 0xFFFFFFFF
    c = np.where(kept, anchor.cnts, 0).astype(np.int64)
    depth = max(2.0, float((c * c).sum()) / max(1, int(c.sum())))
    probes = 2.0 * math.log2(depth)
    b_cost = probes if anchor.leftidx is not None else 1.5 * depth
    hr_eff = max(getattr(anchor, "heavy_rate", 0.0), 0.0)
    anchor_gpp = 3.0 + probes + b_cost + hr_eff * 500.0
    fm_gpp = 2.0 * (math.log(2.0 * anchor.n, 4.0) + 2.0)
    return anchor_gpp, fm_gpp, depth


class _DeviceSearcher:
    """Length-bucketed batching onto the device search kernels.

    Three engines share the batching and host-redo shell: the FM rank walk
    (ops/pingpong.py, K2), the narrow anchor-verify engine
    (ops/anchor_device.py, K3; its pool, K4, is driven by `run_search`)
    and the wide anchor engine (ops/anchor_wide_device.py, K5). The engine
    is chosen as the JAX package chooses it: anchor when anchor tables are
    given and the index holds 2^26 symbols or more (or ``--engine
    anchor``), unless narrow tables report a phase-heavy rate above 5% or
    the cost model prefers FM over wide tables. The FM engine builds a
    k-mer jump table (``config.kmer_jump``) on indexes of 2^22 symbols or
    more, as the JAX package does; the anchor engines ignore it. Any lane
    that overflows or needs the exact path is redone on the host."""

    def __init__(self, index: FMDIndex, config: Config, device=None,
                 anchor=None):
        self.device = resolve_device(device)
        self.index = index
        self.config = config
        self.anchor = None
        self.dev = None
        self.wide = False
        self.heavy_resolver = None
        # the JAX package's crossover: the FM walk while its table is
        # small, the anchor engine from 2^26 symbols
        use_anchor = anchor is not None and (
            config.engine == "anchor"
            or (config.engine == "auto" and index.n >= (1 << 26)))
        hr = getattr(anchor, "heavy_rate", -1.0) if anchor is not None \
            else -1.0
        wide_tables = isinstance(anchor, AnchorIndexWide)
        if use_anchor and config.engine == "auto":
            if wide_tables:
                anchor_gpp, fm_gpp, depth = wide_engine_cost(anchor)
                if anchor_gpp > fm_gpp:
                    logger.warning(
                        "search: engine cost model picks FM — anchor "
                        "~%.0f gathers/phase (pw bucket depth %.0f, "
                        "heavy rate %.1f%%) vs FM ~%.0f; --engine "
                        "anchor to override", anchor_gpp, depth,
                        100 * max(hr, 0.0), fm_gpp)
                    use_anchor = False
            elif hr > 0.05:
                # narrow tables fall back per read on heavy k-mers
                logger.warning(
                    "search: anchor tables report %.1f%% phase-heavy "
                    "rate — most reads would fall back; using the FM "
                    "device engine (--engine anchor to override)",
                    100 * hr)
                use_anchor = False
        # parked-phase waves answer heavy phases from the tables' host-side
        # heavy store (None on tables without one: one-shot batches)
        self.wide = use_anchor and wide_tables
        self.heavy_resolver = make_heavy_resolver(anchor) if self.wide \
            else None
        if self.wide:
            self.anchor, self.anchor_params = build_device_anchor_wide(
                anchor, self.device)
            logger.info("search: wide anchor engine on %s (k=%d, tables "
                        "%.2f GiB, %s; host peak RSS %.2f GiB)", self.device,
                        self.anchor_params.k, self.anchor.nbytes / 2 ** 30,
                        "parked-phase waves" if self.heavy_resolver
                        else "one-shot", resource.getrusage(
                            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
        elif use_anchor:
            self.anchor, self.anchor_params = build_device_anchor(
                anchor, self.device)
            logger.info("search: anchor engine on %s (k=%d, tables "
                        "%.2f GiB; host peak RSS %.2f GiB)", self.device,
                        self.anchor_params.k, self.anchor.nbytes / 2 ** 30,
                        resource.getrusage(
                            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
        else:
            self.dev = DeviceFMDIndex.from_host(index, self.device)
            logger.info("search: FM engine on %s (fused table %.1f MiB)",
                        self.device, self.dev.nbytes / 2 ** 20)
        self.jump_k = 0
        self.jump_table = None
        # the JAX package's gate: the FM engine builds the table from 2^22
        # symbols
        if self.dev is not None and config.kmer_jump \
                and index.n >= (1 << 22):
            t0 = time.time()
            self.jump_k = config.kmer_jump
            self.jump_table = build_jump_table(self.dev, self.jump_k)
            if self.jump_table.is_cuda:   # the log line times the build
                torch.cuda.synchronize(self.device)
            logger.info("search: built %d-mer jump table in %.1fs",
                        self.jump_k, time.time() - t0)
        self.lanes = config.lanes
        self.cap = config.max_sfs_per_read
        self.smoothed_input = False
        self.fallbacks = 0
        self._redo_exec = None

    def lanes_for(self, L: int) -> int:
        """Per-bucket lane count: the lane budget is symbol-denominated
        (lanes x L ~ const), so short buckets may grow up to 4x the
        configured lane count. The constants were tuned for the TPU's
        lockstep loop; the output does not depend on them."""
        base = self.lanes * 10_000
        q = max(256, min(4 * self.lanes, base // max(L, 1)))
        return max(256, (q // 256) * 256)

    def round_cap_for(self, L: int) -> int:
        """Lockstep round cap for one-shot narrow-anchor batches, as the
        JAX package sets it: on smoothed input (the XF == 0 filter) lanes
        past ~L/14 rounds (at least 384) go to the host; other inputs keep
        the engine default (0)."""
        if not self.smoothed_input:
            return 0
        return max(384, L // 14)

    def dispatch(self, encoded: List[np.ndarray]):
        """Launch a device batch; returns an opaque handle. A CUDA launch
        returns once queued, so packing the next batch overlaps the
        search of this one."""
        if not encoded:
            return (encoded, None)
        L = _bucket_len(max(len(s) for s in encoded))
        lanes_b = max(self.lanes_for(L),
                      -(-len(encoded) // 256) * 256)
        padded = list(encoded)
        while len(padded) < lanes_b:
            padded.append(np.ones(1, dtype=np.uint8))
        seqs, lens = pack_reads(padded, pad_to=L, device=self.device)
        # emission cap scales with the bucket length: SFS-dense 30 kb
        # reads average ~470 SFS
        cap = max(self.cap, L // 16)
        if self.wide and self.heavy_resolver is not None:
            # parked-phase waves: construction launches wave 1, collect()
            # runs the rest (the round cap is the narrow engine's alone)
            resolver = self.heavy_resolver

            def resolve_phases(lanes, ancs, dirbs, _encs=padded):
                return np.array([resolver(_encs[ln], int(a),
                                          "left" if d == 1 else "right")
                                 for ln, a, d in zip(lanes, ancs, dirbs)],
                                dtype=np.int32)
            res = WideWaveRun(self.anchor, self.anchor_params, seqs, lens,
                              resolve_phases, cap=cap,
                              overlap=self.config.overlap)
        elif self.wide:
            res = batch_search_anchor_wide(self.anchor, self.anchor_params,
                                           seqs, lens, cap=cap,
                                           overlap=self.config.overlap)
        elif self.anchor is not None:
            res = batch_search_anchor(self.anchor, self.anchor_params, seqs,
                                      lens, cap=cap,
                                      max_rounds=self.round_cap_for(L),
                                      overlap=self.config.overlap)
        else:
            res = batch_search(self.dev, seqs, lens, cap=cap,
                               overlap=self.config.overlap,
                               jump_table=self.jump_table,
                               jump_k=self.jump_k)
        return (encoded, res)

    def _redo_pool(self):
        """Single-worker executor for host redos: serializes native-engine
        use while letting redos overlap device batches (ctypes releases
        the GIL)."""
        if self._redo_exec is None:
            from concurrent.futures import ThreadPoolExecutor
            self._redo_exec = ThreadPoolExecutor(max_workers=1)
        return self._redo_exec

    def close(self) -> None:
        if self._redo_exec is not None:
            self._redo_exec.shutdown()
            self._redo_exec = None

    def collect(self, handle):
        """Materialize a dispatched batch's results (blocks on the device).

        Returns (results, deferred): redo slots of results are None and
        deferred is None or (redo_indices, future) to patch in later."""
        encoded, res = handle
        if res is None:
            return [], None
        if isinstance(res, WideWaveRun):
            res = res.finish()
        n_sfs = res.n_sfs.cpu().numpy()
        qs = res.qs.cpu().numpy()
        ln = res.length.cpu().numpy()
        bad = (res.overflow | res.incomplete).cpu().numpy()
        out = []
        redo = []
        for i in range(len(encoded)):
            if bad[i]:
                # exactness guard: host redo
                self.fallbacks += 1
                redo.append(i)
                out.append(None)
            else:
                k = int(n_sfs[i])
                out.append(list(zip(qs[i, :k].tolist(), ln[i, :k].tolist())))
        if not redo:
            return out, None
        fut = self._redo_pool().submit(
            host_search_batch, self.index, [encoded[i] for i in redo],
            self.config.overlap, self.config.threads)
        return out, (redo, fut)


def run_search(config: Config, index: FMDIndex,
               bam: Optional[str] = None, fastx: Optional[str] = None,
               out=None, device=None, anchor=None
               ) -> List[Tuple[str, List[SFS]]]:
    """Run the search stage; returns (and optionally writes) per-read SFSs.

    config.use_device selects the device engines on `device` (cuda unless
    asked otherwise); False runs the exact host engines. `anchor` is the
    host anchor tables (ops/anchor.py or ops/anchor_wide.py) when the
    index has them; with them the engine gate of `_DeviceSearcher` may
    take the anchor engine, and then the pool unless config.pool is False
    (one-shot batches).

    When writing, output is flushed every >= config.max_output accumulated
    SFS (the reference's --omax deferred-output buffering,
    ping_pong.cpp:344-355), bounding writer memory on whole-genome runs.
    """
    if bam:
        reads = eligible_reads_bam_native(bam, config.putative)
        if reads is None:
            reads = eligible_reads_bam(bam, config.putative)
    elif fastx:
        reads = eligible_reads_fastx(fastx)
    else:
        raise ValueError("search needs a BAM or FASTX input")

    searcher = _DeviceSearcher(index, config, device, anchor) \
        if config.use_device else None
    if searcher is not None:
        # smoothed-BAM inputs carry the XF == 0 filter the one-shot round
        # cap is set for (round_cap_for)
        searcher.smoothed_input = bam is not None and config.putative

    groups: List[Tuple[str, List[SFS]]] = []
    t0 = time.time()
    nreads = 0
    unflushed = [0, 0]   # pending SFS count, flushed-group cursor

    def emit(names_hps: List[Tuple[str, int]],
             results: List[List[Tuple[int, int]]]) -> None:
        for (qname, hp), pairs in zip(names_hps, results):
            if not pairs:
                continue
            sfs_list = [SFS(qname, q, l, hp) for q, l in pairs]
            if config.assemble:
                sfs_list = assemble(sfs_list)
            groups.append((qname, sfs_list))
            unflushed[0] += len(sfs_list)
        if out is not None and unflushed[0] >= config.max_output:
            write_sfs_file(out, groups[unflushed[1]:])
            unflushed[:] = [0, len(groups)]

    if searcher is None:
        # host path: native threaded batches (Python-oracle fallback inside)
        batch: List = []

        def flush_host() -> None:
            nonlocal batch
            if not batch:
                return
            res = host_search_batch(index, [e for _, _, e in batch],
                                    config.overlap, config.threads)
            emit([(q, h) for q, h, _ in batch], res)
            batch = []

        for qname, seq, hp in reads:
            batch.append((qname, hp, seq if isinstance(seq, np.ndarray)
                          else encode_nt6(seq)))
            nreads += 1
            if len(batch) >= config.batch_size:
                flush_host()
        flush_host()
    elif searcher.anchor is not None and not searcher.wide and config.pool:
        # persistent-lane pool (narrow tables; the wide engine runs one-shot
        # batches or waves below): ONE pool serves every read-length bucket,
        # recreated at a wider shape when a longer bucket appears (after
        # draining the narrower one, as the JAX package's driver does)
        pool: Optional[AnchorPool] = None
        order: List[Tuple[str, int]] = []          # ordinal -> (qname, hp)
        results_store: Dict[int, List[Tuple[int, int]]] = {}
        enc_store: Dict[int, np.ndarray] = {}      # in-flight + redo
        redo: List[int] = []
        emitted = [0]                              # next ordinal to emit

        def flush_redo() -> None:
            if not redo:
                return
            res = host_search_batch(index, [enc_store.pop(i) for i in redo],
                                    config.overlap, config.threads)
            for i, r in zip(redo, res):
                results_store[i] = r
            redo.clear()

        def emit_ready() -> None:
            """Emit the completed prefix in stream order, releasing
            buffered results as it goes."""
            while emitted[0] in results_store:
                tag = emitted[0]
                emitted[0] += 1
                qname, hp = order[tag]
                emit([(qname, hp)], [results_store.pop(tag)])

        def absorb(done) -> None:
            for tag, pairs in done:
                if pairs is None:
                    searcher.fallbacks += 1
                    redo.append(tag)
                else:
                    results_store[tag] = pairs
                    del enc_store[tag]
            if len(redo) >= 256:
                flush_redo()
            emit_ready()

        for qname, seq, hp in _prefetch(reads):
            enc = seq if isinstance(seq, np.ndarray) else encode_nt6(seq)
            b = _bucket_len(len(enc))
            if pool is None or b > pool.Lp1 - 1:
                if pool is not None:
                    absorb(pool.drain())
                pool = AnchorPool(searcher.anchor, searcher.anchor_params,
                                  lanes=config.lanes, read_len=b,
                                  cap=searcher.cap, overlap=config.overlap)
            tag = nreads
            nreads += 1
            order.append((qname, hp))
            enc_store[tag] = enc
            pool.feed(tag, enc)
            if pool.queued >= pool.M:
                absorb(pool.pump())
        if pool is not None:
            absorb(pool.drain())
        flush_redo()
        emit_ready()
        assert emitted[0] == nreads, "pool lost reads"
    else:
        # accumulate per length bucket; flush full batches
        buckets: Dict[int, List] = {}
        order: List[Tuple[int, str, int]] = []  # (bucket, qname, idx-in-bucket)
        results_store: Dict[Tuple[int, int], List] = {}
        flushed: Dict[int, int] = {}

        pending: List = []
        deferred: List = []          # (bucket, base, redo_idx, future)

        def drain(keep: int = 0) -> None:
            while len(pending) > keep:
                bucket, batch, handle = pending.pop(0)
                res, d = searcher.collect(handle)
                base = flushed.get(bucket, 0)
                for k, r in enumerate(res):
                    results_store[(bucket, base + k)] = (batch[k][0],
                                                         batch[k][1], r)
                if d is not None:
                    deferred.append((bucket, base, d[0], d[1]))
                flushed[bucket] = base + len(batch)

        def flush(bucket: int) -> None:
            batch = buckets.pop(bucket, [])
            if not batch:
                return
            encs = [e for _, _, e in batch]
            handle = searcher.dispatch(encs)
            pending.append((bucket, batch, handle))
            drain(keep=1)   # overlap: keep one batch in flight

        counters: Dict[int, int] = {}
        try:
            for qname, seq, hp in _prefetch(reads):
                enc = seq if isinstance(seq, np.ndarray) else encode_nt6(seq)
                b = _bucket_len(len(enc))
                idx = counters.get(b, 0)
                counters[b] = idx + 1
                buckets.setdefault(b, []).append((qname, hp, enc))
                order.append((b, qname, idx))
                nreads += 1
                if len(buckets[b]) >= searcher.lanes_for(b):
                    flush(b)
            for b in list(buckets):
                flush(b)
            drain(keep=0)
            for bucket, base, redo_idx, fut in deferred:
                for i, r in zip(redo_idx, fut.result()):
                    qn, hp, _ = results_store[(bucket, base + i)]
                    results_store[(bucket, base + i)] = (qn, hp, r)
        finally:
            searcher.close()
        for b, qname, idx in order:
            qn, hp, pairs = results_store[(b, idx)]
            emit([(qn, hp)], [pairs])

    dt = time.time() - t0
    logger.info("search: %d reads in %.2fs (%.1f reads/s)%s",
                nreads, dt, nreads / max(dt, 1e-9),
                f", {searcher.fallbacks} host fallbacks" if searcher else "")
    if out is not None:
        write_sfs_file(out, groups[unflushed[1]:])
    return groups
