"""``smooth`` stage: replace SNVs/small indels/errors with reference bases.

Host-side reimplementation of ``Smoother`` (smoother.cpp). Per read, walk the
CIGAR (smooth_read, smoother.cpp:84-232):

  * M/=/X stretches  -> emit *reference* bases (this erases SNVs), original
    qualities; merged into the previous M op (plus any pending short-DEL
    fill length m_diff);
  * INS <= min_indel_length (20) -> dropped from the read;
    longer INS kept (likely SV evidence);
  * DEL <= 20 -> filled with reference bases (m_diff merges the fill into
    the surrounding M); longer DEL kept as a D op;
  * soft clips kept verbatim; any other op aborts the walk (smoother.cpp:186).

Reads whose mismatch/match ratio exceeds the sample's ``accp`` percentile
threshold (first `accuracy_sample` alignments, compute_maxaccuracy,
smoother.cpp:259-346) are tagged XF=1 and left unmodified; reads with no
long indel or clip are tagged XF=2; smoothed reads get the new
sequence/quality/CIGAR and XF=0. Eligibility (load_batch_bam,
smoother.cpp:498-571): primary alignments, mapq >= min_mapq, length >= 2,
on a reference chromosome — others are dropped from the output.

Known reference quirk, reproduced for parity: a short-DEL fill immediately
followed by a kept long INS emits the fill bases before the INS bases in
the sequence, but the CIGAR records I before the M that includes the fill.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from ..io.bam import (BamReader, BamRecord, BamWriter, BAM_CMATCH, BAM_CINS,
                      BAM_CDEL, BAM_CEQUAL, BAM_CDIFF, BAM_CSOFT_CLIP)
from ..utils.log import logger
from ..utils.seq import percentile

_MATCH_OPS = (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF)


class _RefCache:
    """Chromosome sequences as uint8 arrays (vectorized compares)."""

    def __init__(self, chroms: Dict[str, str]):
        self._chroms = chroms
        self._arrays: Dict[str, np.ndarray] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._chroms

    def get(self, name: str) -> np.ndarray:
        arr = self._arrays.get(name)
        if arr is None:
            arr = np.frombuffer(self._chroms[name].encode(), dtype=np.uint8)
            self._arrays[name] = arr
        return arr


def _mismatch_stats(rec: BamRecord, ref: np.ndarray) -> Tuple[int, int]:
    """(num_match, num_mismatch) over M/=/X ops; stops at unknown ops
    (compute_maxaccuracy walk, smoother.cpp:314-336)."""
    nmatch = 0
    nmis = 0
    ref_off = rec.pos
    q_off = 0
    seq = np.frombuffer(rec.seq.encode(), dtype=np.uint8)
    for ln, op in rec.cigar:
        if op in _MATCH_OPS:
            eq = int(np.count_nonzero(ref[ref_off:ref_off + ln]
                                      == seq[q_off:q_off + ln]))
            nmatch += eq
            nmis += ln - eq
            ref_off += ln
            q_off += ln
        elif op == BAM_CINS:
            q_off += ln
        elif op == BAM_CDEL:
            ref_off += ln
        elif op == BAM_CSOFT_CLIP:
            q_off += ln
        else:
            break
    return nmatch, nmis


def compute_max_accuracy(bam_path, chroms: Dict[str, str],
                         config: Config) -> float:
    """accp percentile of per-read mismatch/match ratios over the first
    `accuracy_sample` eligible alignments (smoother.cpp:259-346)."""
    ratios: List[float] = []
    cache = _RefCache(chroms)
    with BamReader(bam_path) as reader:
        names = reader.header.names
        for rec in reader:
            if len(ratios) >= config.accuracy_sample:
                break
            if not rec.is_primary or rec.mapq < config.min_mapq:
                continue
            if rec.l_seq < 2 or rec.tid < 0:
                continue
            chrom = names[rec.tid]
            if chrom not in chroms:
                continue
            nmatch, nmis = _mismatch_stats(rec, cache.get(chrom))
            ratios.append(nmis / nmatch if nmatch else float("inf"))
    if not ratios:
        return float("inf")
    ratios.sort()
    return percentile(ratios, config.accp)


def smooth_read(rec: BamRecord, ref, config: Config,
                threshold: float) -> None:
    """Rewrite rec in place; sets the XF tag (smooth_read, smoother.cpp:84).

    ref may be a str or a uint8 array (the run loop passes arrays)."""
    if isinstance(ref, str):
        ref_arr = np.frombuffer(ref.encode(), dtype=np.uint8)
    else:
        ref_arr = ref
    seq_arr = np.frombuffer(rec.seq.encode(), dtype=np.uint8)
    new_seq: List[np.ndarray] = []
    new_qual = bytearray()
    new_cigar: List[Tuple[int, int]] = []
    should_ignore = True
    ref_off = rec.pos
    q_off = 0          # match + ins + soft-clip offset into the read
    m_diff = 0
    nmatch = 0
    nmis = 0
    qual = rec.qual
    min_indel = config.min_indel_length
    for ln, op in rec.cigar:
        if op in _MATCH_OPS:
            new_seq.append(ref_arr[ref_off:ref_off + ln])
            new_qual += qual[q_off:q_off + ln]
            eq = int(np.count_nonzero(ref_arr[ref_off:ref_off + ln]
                                      == seq_arr[q_off:q_off + ln]))
            nmatch += eq
            nmis += ln - eq
            ref_off += ln
            q_off += ln
            if new_cigar and new_cigar[-1][1] == BAM_CMATCH:
                new_cigar[-1] = (new_cigar[-1][0] + ln + m_diff, BAM_CMATCH)
            else:
                new_cigar.append((ln + m_diff, BAM_CMATCH))
            m_diff = 0
        elif op == BAM_CINS:
            if ln > min_indel:
                should_ignore = False
                new_seq.append(seq_arr[q_off:q_off + ln])
                new_qual += qual[q_off:q_off + ln]
                new_cigar.append((ln, BAM_CINS))
            q_off += ln
        elif op == BAM_CDEL:
            if ln <= min_indel:
                new_seq.append(ref_arr[ref_off:ref_off + ln])
                new_qual += qual[q_off:q_off + ln]
                m_diff += ln
            else:
                should_ignore = False
                new_cigar.append((ln, BAM_CDEL))
            ref_off += ln
        elif op == BAM_CSOFT_CLIP:
            should_ignore = False
            new_seq.append(seq_arr[q_off:q_off + ln])
            new_qual += qual[q_off:q_off + ln]
            new_cigar.append((ln, BAM_CSOFT_CLIP))
            q_off += ln
        else:
            break
    # IEEE parity with the reference's double division (smoother.cpp:213):
    # x/0 = +inf -> dirty; 0/0 = NaN, and NaN > threshold is false -> the
    # read falls through to the should_ignore test
    if nmatch == 0:
        dirty = nmis > 0 and threshold != float("inf")
    else:
        dirty = nmis / nmatch > threshold
    if dirty:
        rec.set_tag("XF", "i", 1)     # too dirty: left unmodified
    elif should_ignore:
        rec.set_tag("XF", "i", 2)     # nothing SV-like on this read
    else:
        seq_arr_new = (np.concatenate(new_seq) if new_seq
                       else np.empty(0, dtype=np.uint8))
        # internal-error guard (smoother.cpp:218-227): the rebuilt
        # sequence must match the new CIGAR's query length and its quals
        expect = sum(ln for ln, op in new_cigar
                     if op in (BAM_CMATCH, BAM_CINS, BAM_CSOFT_CLIP))
        if len(seq_arr_new) != expect or len(new_qual) != len(seq_arr_new):
            logger.warning("smooth: inconsistent rewrite for %s "
                           "(seq %d, cigar %d, qual %d) — tagging XF=3",
                           rec.qname, len(seq_arr_new), expect,
                           len(new_qual))
            rec.set_tag("XF", "i", 3)
            return
        rec.seq = seq_arr_new.tobytes().decode()
        rec.qual = bytes(new_qual)
        rec.cigar = new_cigar
        rec.set_tag("XF", "i", 0)


def _bind_native_smooth(lib) -> bool:
    import ctypes
    if not hasattr(lib, "svdss_smooth_run"):
        return False
    if getattr(lib, "_smooth_bound", False):
        return True
    P8 = ctypes.POINTER(ctypes.c_uint8)
    P64 = ctypes.POINTER(ctypes.c_int64)
    lib.svdss_smooth_ratios.argtypes = [
        P8, ctypes.c_int64, P64, ctypes.c_int64, P8, P64, P64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), P64]
    lib.svdss_smooth_ratios.restype = ctypes.c_int
    lib.svdss_smooth_run.argtypes = [
        P8, ctypes.c_int64, P64, ctypes.c_int64, P8, P64, P64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), P64, P64]
    lib.svdss_smooth_run.restype = ctypes.c_int
    lib.svdss_bgzf_write.argtypes = [
        ctypes.c_char_p, P8, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.svdss_bgzf_write.restype = ctypes.c_int
    lib.svdss_bam_scan2 = lib.svdss_bam_scan
    lib._smooth_bound = True
    return True


def _native_smooth(config: Config, chroms: Dict[str, str], bam_path: str,
                   out_path: str):
    """Native fast path (native/smooth.cpp): threaded CIGAR rewrite +
    parallel BGZF deflate. Field-identical records to the Python path
    (tests/test_smooth_native.py); returns stats, or None when the native
    library is unavailable."""
    import ctypes

    from ..io import native as nat
    lib = nat.load()
    if lib is None or not _bind_native_smooth(lib):
        return None
    data = nat.bgzf_read_all(bam_path)
    if data is None:
        return None
    t0 = time.time()
    buf = np.frombuffer(data, dtype=np.uint8)
    P8 = ctypes.POINTER(ctypes.c_uint8)
    P64 = ctypes.POINTER(ctypes.c_int64)
    datap = buf.ctypes.data_as(P8)
    recsp = ctypes.c_void_p()
    nrecs = ctypes.c_int64()
    if lib.svdss_bam_scan(datap, len(buf), ctypes.byref(recsp),
                          ctypes.byref(nrecs)) != 0:
        return None
    try:
        header = BamReader(data).header
        ref_parts = []
        ref_off = np.full(max(1, len(header.names)), -1, dtype=np.int64)
        ref_len = np.zeros(max(1, len(header.names)), dtype=np.int64)
        off = 0
        for t, name in enumerate(header.names):
            if name in chroms:
                s = chroms[name].encode()
                ref_parts.append(s)
                ref_off[t] = off
                ref_len[t] = len(s)
                off += len(s)
        ref_buf = np.frombuffer(b"".join(ref_parts), dtype=np.uint8) \
            if ref_parts else np.zeros(1, dtype=np.uint8)
        recs64 = ctypes.cast(recsp, P64)

        sample_n = config.accuracy_sample
        ratios = np.empty(max(1, sample_n), dtype=np.float64)
        got = ctypes.c_int64()
        lib.svdss_smooth_ratios(
            datap, len(buf), recs64, nrecs,
            ref_buf.ctypes.data_as(P8), ref_off.ctypes.data_as(P64),
            ref_len.ctypes.data_as(P64), ctypes.c_int32(len(header.names)),
            ctypes.c_int32(config.min_mapq), ctypes.c_int32(sample_n),
            ratios.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(got))
        if got.value == 0:
            threshold = float("inf")
        else:
            rl = sorted(ratios[:got.value].tolist())
            threshold = percentile(rl, config.accp)
        logger.info("smooth: max allowed mismatch ratio %.5f", threshold)

        # header part first (create, no EOF); record chunks append and
        # the last one adds the EOF block. level-1: intermediate
        # artifact read back only by us. The rewrite runs over BOUNDED
        # record slices — a single whole-file pass held the full
        # rewritten stream (and its growth reallocations) in RAM and
        # OOM-killed the 1 Gbp / 30x run (raw BAM ~26 GB, peak >120 GB)
        hdr = _header_bytes(header)
        hbuf = np.frombuffer(hdr, dtype=np.uint8)
        if lib.svdss_bgzf_write(out_path.encode(),
                                hbuf.ctypes.data_as(P8), len(hdr),
                                1, max(1, config.threads), 2) != 0:
            return None
        stats_a = np.zeros(5, dtype=np.int64)
        n_all = int(nrecs.value)
        CHUNK = int(os.environ.get("SVDSS_SMOOTH_CHUNK", 200_000))
        done = 0
        while done < n_all or n_all == 0:
            cnt = min(CHUNK, n_all - done)
            outp = ctypes.c_void_p()
            outsz = ctypes.c_int64()
            stats_c = np.zeros(5, dtype=np.int64)
            if cnt:
                rec_at = ctypes.cast(
                    ctypes.addressof(recs64.contents) + done * 64, P64)
                rc = lib.svdss_smooth_run(
                    datap, len(buf), rec_at, cnt,
                    ref_buf.ctypes.data_as(P8),
                    ref_off.ctypes.data_as(P64),
                    ref_len.ctypes.data_as(P64),
                    ctypes.c_int32(len(header.names)),
                    ctypes.c_double(threshold),
                    ctypes.c_int32(config.min_mapq),
                    ctypes.c_int32(config.min_indel_length),
                    ctypes.c_int(max(1, config.threads)),
                    ctypes.byref(outp), ctypes.byref(outsz),
                    stats_c.ctypes.data_as(P64))
                if rc != 0:
                    return None
            done += cnt
            try:
                flags = 1 if done >= n_all else 3   # EOF on last chunk
                if lib.svdss_bgzf_write(out_path.encode(),
                                        ctypes.cast(outp, P8),
                                        outsz, 1,
                                        max(1, config.threads),
                                        flags) != 0:
                    return None
            finally:
                if cnt:
                    lib.svdss_free(outp)
            stats_a += stats_c
            if n_all == 0:
                break
    finally:
        lib.svdss_free(recsp)
    stats = {0: int(stats_a[0]), 1: int(stats_a[1]), 2: int(stats_a[2]),
             3: int(stats_a[3]), "dropped": int(stats_a[4])}
    nproc = int(nrecs.value)
    dt = time.time() - t0
    logger.info("smooth: %d alignments in %.2fs (%.1f aln/s, native); "
                "XF0=%d XF1=%d XF2=%d XF3=%d dropped=%d", nproc, dt,
                nproc / max(dt, 1e-9), stats[0], stats[1], stats[2],
                stats[3], stats["dropped"])
    return stats


def _header_bytes(header) -> bytes:
    """BAM header block exactly as BamWriter serializes it."""
    import struct
    text_b = header.text.encode()
    parts = [b"BAM\x01", struct.pack("<i", len(text_b)), text_b,
             struct.pack("<i", len(header.refs))]
    for name, length in header.refs:
        nb = name.encode() + b"\x00"
        parts.append(struct.pack("<i", len(nb)) + nb
                     + struct.pack("<i", length))
    return b"".join(parts)


def run_smooth(config: Config, chroms: Dict[str, str], bam_path: str,
               out_path: str, use_native: bool = True) -> Dict[str, int]:
    """Smooth a BAM into out_path; returns XF-tag counts.

    The native path (threaded rewrite + parallel deflate) runs when the
    library is built; otherwise the BAM is decompressed once (shared
    between the accuracy pass and the main pass) and written through a
    background thread — zlib deflate releases the GIL, so record
    encode/compress overlaps the CIGAR rewrite (the role of the
    reference's triple-buffered writer lane, smoother.cpp:412-465)."""
    import queue
    import threading

    if use_native:
        stats = _native_smooth(config, chroms, bam_path, out_path)
        if stats is not None:
            return stats

    from ..io.native import bgzf_read_all
    data = bgzf_read_all(bam_path)
    src = data if data is not None else bam_path

    threshold = compute_max_accuracy(src, chroms, config)
    logger.info("smooth: max allowed mismatch ratio %.5f", threshold)
    stats = {0: 0, 1: 0, 2: 0, 3: 0, "dropped": 0}
    t0 = time.time()
    nproc = 0
    cache = _RefCache(chroms)
    with BamReader(src) as reader:
        names = reader.header.names
        # level-1 deflate: the smoothed BAM is an intermediate artifact,
        # read back only by this framework (3-4x faster than level 6)
        writer = BamWriter(out_path, reader.header, level=1)
        wq: "queue.Queue" = queue.Queue(maxsize=4096)
        werr = []

        def drain():
            try:
                while True:
                    rec = wq.get()
                    if rec is None:
                        return
                    writer.write(rec)
            except BaseException as exc:
                werr.append(exc)

        wt = threading.Thread(target=drain)
        wt.start()
        try:
            for rec in reader:
                nproc += 1
                if (not rec.is_primary or rec.mapq < config.min_mapq
                        or rec.l_seq < 2 or rec.tid < 0
                        or names[rec.tid] not in chroms):
                    stats["dropped"] += 1
                    continue
                smooth_read(rec, cache.get(names[rec.tid]), config,
                            threshold)
                stats[rec.get_tag("XF")] += 1
                wq.put(rec)
        finally:
            wq.put(None)
            wt.join()
            writer.close()
        if werr:
            raise werr[0]
    dt = time.time() - t0
    logger.info("smooth: %d alignments in %.2fs (%.1f aln/s); "
                "XF0=%d XF1=%d XF2=%d XF3=%d dropped=%d", nproc, dt,
                nproc / max(dt, 1e-9), stats[0], stats[1], stats[2],
                stats[3], stats["dropped"])
    return stats
