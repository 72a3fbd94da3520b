"""``search`` stage: extract sample-specific strings from reads.

Pipeline equivalent of ``PingPong::search`` (ping_pong.cpp:239-397), rebuilt
around the batched device kernel:

  * stream the (smoothed) BAM, keeping primary alignments with
    l_qseq >= 100 and (by default) XF == 0 — the same eligibility rules as
    load_batch_bam/process_batch (ping_pong.cpp:66-79, 196-203);
  * encode reads to nt6 and pack them into length-bucketed lane batches
    (powers of two);
  * run the device search (ops/pingpong.py: the FM rank walk, kernel K2
    on the card), falling back to the exact host search for any lane that
    overflows its emission buffer or step budget — output is exact either
    way;
  * optionally merge overlapping SFSs per read (ops/assemble.py, on by
    default like ``--noassemble``'s inverse) and write the 4-column
    specifics.txt.

Output records appear in BAM order (the reference emits a thread-count-
dependent per-batch lexicographic permutation, ping_pong.cpp:213-236 with
``map<string, vector<SFS>>``; downstream parses the file into a map keyed by
read name, so ordering is immaterial — documented deviation).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..index.fmd import FMDIndex
from ..io.bam import BamReader
from ..io.sfs_file import write_sfs_file
from ..models import SFS
from ..ops.assemble import assemble
from ..ops.fmd import DeviceFMDIndex
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

class _DeviceSearcher:
    """Length-bucketed batching onto the FM rank-walk kernel.

    Reads are packed per length bucket into batches of `lanes_for` lanes
    and searched by `ops.pingpong.batch_search` on the searcher's device;
    any lane that overflows its emission buffer or its step budget is
    redone exactly on the host. The anchor engines of the JAX package are
    not ported yet."""

    def __init__(self, index: FMDIndex, config: Config, device=None):
        if config.engine == "anchor":
            raise NotImplementedError(
                "the anchor search engines are not ported yet; use "
                "--engine fm (or auto)")
        if config.kmer_jump:
            raise NotImplementedError(
                "the k-mer jump table is not ported yet (kmer_jump=0)")
        if config.engine == "auto":
            logger.info("search: --engine auto takes the FM engine (the "
                        "anchor engines are not ported yet)")
        self.device = resolve_device(device)
        self.index = index
        self.config = config
        self.dev = DeviceFMDIndex.from_host(index, self.device)
        logger.info("search: FM engine on %s (fused table %.1f MiB)",
                    self.device, self.dev.nbytes / 2 ** 20)
        self.lanes = config.lanes
        self.cap = config.max_sfs_per_read
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
        res = batch_search(self.dev, seqs, lens, cap=cap,
                           overlap=self.config.overlap)
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
               out=None, device=None) -> List[Tuple[str, List[SFS]]]:
    """Run the search stage; returns (and optionally writes) per-read SFSs.

    config.use_device selects the FM kernel on `device` (cuda unless
    asked otherwise); False runs the exact host engines.

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

    searcher = _DeviceSearcher(index, config, device) \
        if config.use_device else None

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
