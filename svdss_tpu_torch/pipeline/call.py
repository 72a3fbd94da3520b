"""``call`` stage: place SFSs, cluster, consensus, realign, emit SVs.

Reimplements the reference call path (Caller::run -> Clusterer::run -> pcall,
caller.cpp:3-57) with the same heuristics:

  1. align_and_extend (clusterer.cpp:56-346): for every primary alignment
     with SFSs, locate each SFS's reference span through the aligned pairs,
     extend to the nearest unique k-mer (k=7) within 100bp flanks, merge
     overlapping extended SFSs per read, collect soft-clip evidence;
  2. cluster_by_proximity (clusterer.cpp:407-474): sort by (chrom, ref
     start), window split at 1.1x the max extended length, greedy
     interval-overlap clustering inside windows;
  3. fill_clusters (clusterer.cpp:477-610): unify cluster coordinates,
     compute HP-split coverage and the genotyper read vector, extract each
     supporting read's subsequence spanning the cluster. The reference
     random-accesses the BAM per cluster (sam_itr_querys,
     clusterer.cpp:524-527); we make one streaming pass over the
     position-sorted BAM against the sorted cluster list instead — same
     records, same order, no .bai needed;
  4. pcall (caller.cpp:311-406): split clusters by haplotype then length
     (reproducing the reference's int-truncated best-ratio quirk,
     caller.cpp:158-210), POA consensus per subcluster, dual-affine global
     realignment to the cluster reference window, CIGAR walk emitting
     INS/DEL >= min_sv_length with a 1bp left anchor base;
  5. clean_dups + filter_sv_chains (caller.cpp:409-475) with an exact
     rapidfuzz fuzz::ratio equivalent (normalized indel similarity).

Deviation: the reference clusters are keyed (low, high) only
(clusterer.cpp:461), silently merging same-coordinate clusters from
different chromosomes within one worker's map; we key by (chrom, low, high).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..io.bam import (BamReader, BamRecord, BAM_CSOFT_CLIP,
                      aligned_pairs_arrays)
from ..models import SFS, SV, Clip, Cluster, Consensus
from ..ops.align import align_dual_gap, AlignParams
from ..ops.poa import poa_consensus
from ..utils.log import logger


class CallStats:
    def __init__(self):
        self.unplaced = 0
        self.s_unplaced = 0
        self.e_unplaced = 0
        self.unknown = 0
        self.unextended = 0
        self.small_clusters = 0
        self.small_clusters_2 = 0


# ---------------------------------------------------------------- placement

def get_unique_kmers(alpairs: List[Tuple[int, int]], k: int, from_end: bool,
                     chrom_seq: str) -> Tuple[int, int]:
    """First (from_end: last) fully-placed k-mer with a single occurrence in
    the flank; falls back to the last clean window examined
    (clusterer.cpp:351-405, including that final-fallback quirk)."""
    n = len(alpairs)
    if n < k:
        return (-1, -1)
    kmers: Dict[str, int] = {}
    i = 0
    while i < n - k + 1:
        skip = False
        for j in range(i, i + k):
            if alpairs[j][0] == -1 or alpairs[j][1] == -1:
                skip = True
                i = j + 1
                break
        if skip:
            continue
        kmer = chrom_seq[alpairs[i][1]:alpairs[i][1] + k]
        kmers[kmer] = kmers.get(kmer, 0) + 1
        i += 1
    last_kmer = (-1, -1)
    i = 0
    while i < n - k + 1:
        offset = (n - k - i) if from_end else i
        skip = False
        for j in range(offset, offset + k):
            if alpairs[j][0] == -1 or alpairs[j][1] == -1:
                skip = True
                i += j - offset
                break
        if skip:
            i += 1
            continue
        last_kmer = alpairs[offset]
        kmer = chrom_seq[alpairs[offset][1]:alpairs[offset][1] + k]
        if kmers.get(kmer, 0) == 1:
            break
        i += 1
    return last_kmer


def extend_alignment(rec: BamRecord, sfs_list: List[SFS], chrom: str,
                     chrom_seq: str, cfg: Config, stats: CallStats,
                     clips: List[Clip]) -> List[SFS]:
    """Place one read's SFSs on the reference (clusterer.cpp:159-346).

    The reference's per-base scan over aligned pairs is replaced by
    searchsorted over the (monotone) placed-pair query positions; the
    stateful ``last_pos`` cursor is preserved exactly (it makes SFSs
    arriving out of query order — possible with --noassemble — fall into
    the unplaced paths just as in the C code, clusterer.cpp:184-201)."""
    aq, ar = aligned_pairs_arrays(rec)
    valid = (aq != -1) & (ar != -1)
    vidx = np.flatnonzero(valid).astype(np.int64)
    vq = aq[vidx]
    vr = ar[vidx]
    lclip = (0, 0)
    rclip = (0, 0)
    last_pos = 0
    local: List[SFS] = []
    for sfs in sfs_list:
        s = sfs.qs
        e = sfs.qs + sfs.l - 1
        aln_start = -1
        aln_end = -1
        refs = -1
        refe = -1
        pv = int(np.searchsorted(vidx, last_pos, "left"))
        ls = int(np.searchsorted(vq, s, "left")) - 1
        if ls >= pv:
            refs = int(vr[ls])
            aln_start = int(vidx[ls])
            last_pos = aln_start
        fe = max(int(np.searchsorted(vq, e, "right")), pv)
        if fe < len(vq):
            refe = int(vr[fe])
            aln_end = int(vidx[fe])
        if refs == -1 and refe == -1:
            stats.unplaced += 1
            continue
        elif refs == -1:
            ln0, op0 = rec.cigar[0]
            if op0 == BAM_CSOFT_CLIP and cfg.clipped:
                lclip = (rec.pos, ln0)
            else:
                stats.s_unplaced += 1
            continue
        elif refe == -1:
            lnl, opl = rec.cigar[-1]
            if opl == BAM_CSOFT_CLIP and cfg.clipped:
                rclip = (rec.end_pos(), lnl)
            else:
                stats.e_unplaced += 1
            continue
        local_alpairs: List[Tuple[int, int]] = []
        last_r = refs - 1
        sq = aq[aln_start:aln_end + 1].tolist()
        sr = ar[aln_start:aln_end + 1].tolist()
        for q, r in zip(sq, sr):
            if r == -1:
                if refs <= last_r <= refe:
                    local_alpairs.append((q, r))
            else:
                last_r = r
                if refs <= r <= refe:
                    local_alpairs.append((q, r))
            if q != -1 and r != -1 and r >= refe:
                break
        # flanking pairs (up to cfg.flank each side)
        p0 = max(aln_start - cfg.flank, 0)
        pre_alpairs = list(zip(aq[p0:aln_start].tolist(),
                               ar[p0:aln_start].tolist()))
        p1 = min(aln_end + 1 + cfg.flank, len(aq))
        post_alpairs = list(zip(aq[aln_end + 1:p1].tolist(),
                                ar[aln_end + 1:p1].tolist()))
        prekmer = get_unique_kmers(pre_alpairs, cfg.ksize, True, chrom_seq)
        postkmer = get_unique_kmers(post_alpairs, cfg.ksize, False, chrom_seq)
        if prekmer[0] == -1 or prekmer[1] == -1:
            prekmer = local_alpairs[0] if local_alpairs else (-1, -1)
        if postkmer[0] == -1 or postkmer[1] == -1:
            postkmer = local_alpairs[-1] if local_alpairs else (-1, -1)
        if (prekmer[0] == -1 or prekmer[1] == -1
                or postkmer[0] == -1 or postkmer[1] == -1):
            stats.unknown += 1
            continue
        if prekmer[1] > postkmer[1] + cfg.ksize:
            logger.warning("SFS placement error on %s at %d (len %d)",
                           rec.qname, sfs.qs, sfs.l)
        else:
            local.append(SFS.placed(chrom, rec.qname, prekmer[1],
                                    postkmer[1] + cfg.ksize, prekmer[0],
                                    postkmer[0] + cfg.ksize, sfs.htag))
    # merge overlapping extended SFSs, first-match-wins like
    # clusterer.cpp:314-336
    merged: List[SFS] = []
    for cur in local:
        j = None
        for jj, m in enumerate(merged):
            if (cur.rs <= m.rs <= cur.re) or (m.rs <= cur.rs <= m.re):
                j = jj
                break
        if j is not None:
            m = merged[j]
            m.rs = min(m.rs, cur.rs)
            m.re = max(m.re, cur.re)
            m.qs = min(m.qs, cur.qs)
            m.qe = max(m.qe, cur.qe)
        else:
            merged.append(cur)
    if lclip[1] > 0:
        clips.append(Clip(rec.qname, chrom, lclip[0], lclip[1], True))
    if rclip[1] > 0:
        clips.append(Clip(rec.qname, chrom, rclip[0], rclip[1], False))
    return merged


def align_and_extend(bam_path, sfs_map: Dict[str, List[SFS]],
                     chroms: Dict[str, str], cfg: Config, stats: CallStats
                     ) -> Tuple[List[SFS], List[Clip]]:
    extended: List[SFS] = []
    clips: List[Clip] = []
    with BamReader(bam_path) as reader:
        names = reader.header.names
        for rec in reader:
            if not rec.is_primary:
                continue
            if rec.mapq < cfg.min_mapq:
                continue
            if rec.qname not in sfs_map:
                continue
            chrom = names[rec.tid]
            if chrom not in chroms:
                continue
            extended.extend(
                extend_alignment(rec, sfs_map[rec.qname], chrom,
                                 chroms[chrom], cfg, stats, clips))
    return extended, clips


# ---------------------------------------------------------------- clustering

def cluster_by_proximity(extended: List[SFS], cfg: Config) -> List[Cluster]:
    """clusterer.cpp:407-474 (including the window-gap quirk that measures
    the gap from the *first* element's end of the current window)."""
    if not extended:
        return []
    extended = sorted(extended, key=lambda s: (s.chrom, s.rs))
    maxlen = max(s.re - s.rs for s in extended)
    dist = int(maxlen * cfg.cluster_separation_factor)
    logger.info("call: max extended SFS length %dbp, separation %dbp",
                maxlen, dist)
    intervals: List[Tuple[int, int]] = []
    prev_i = 0
    prev_e = extended[0].re
    prev_chrom = extended[0].chrom
    for i in range(1, len(extended)):
        sfs = extended[i]
        if sfs.chrom != prev_chrom:
            prev_chrom = sfs.chrom
            intervals.append((prev_i, i - 1))
            prev_i = i
            prev_e = sfs.re
        elif sfs.rs - prev_e > dist:
            intervals.append((prev_i, i - 1))
            prev_e = sfs.re
            prev_i = i
    intervals.append((prev_i, len(extended) - 1))

    clusters: List[Cluster] = []
    for lo_i, hi_i in intervals:
        j = lo_i
        low = extended[j].rs
        high = extended[j].re
        last_j = j
        j += 1
        while j <= hi_i:
            sfs = extended[j]
            if sfs.rs <= high:
                low = min(low, sfs.rs)
                high = max(high, sfs.re)
            else:
                clusters.append(Cluster.from_sfs(extended[last_j:j]))
                low = sfs.rs
                high = sfs.re
                last_j = j
            j += 1
        clusters.append(Cluster.from_sfs(extended[last_j:hi_i + 1]))
    return clusters


def fill_clusters(bam_path, clusters: List[Cluster],
                  chroms: Dict[str, str], cfg: Config,
                  stats: CallStats) -> None:
    """Coverage + subread extraction, one streaming pass
    (clusterer.cpp:477-610 semantics; see module docstring)."""
    # precompute per-cluster region + read set; skip underweight early
    live: List[int] = []
    meta = {}
    for ci, cluster in enumerate(clusters):
        reads = set()
        min_s = min(s.rs for s in cluster.SFSs)
        max_e = max(s.re for s in cluster.SFSs)
        for s in cluster.SFSs:
            reads.add(s.qname)
        if len(reads) < cfg.min_cluster_weight:
            stats.small_clusters += 1
            continue
        cluster.set_coordinates(min_s, max_e)
        meta[ci] = (reads, [0, 0, 0], [])
        live.append(ci)

    by_chrom: Dict[str, List[int]] = {}
    for ci in live:
        by_chrom.setdefault(clusters[ci].chrom, []).append(ci)
    for lst in by_chrom.values():
        lst.sort(key=lambda ci: clusters[ci].s)

    with BamReader(bam_path) as reader:
        names = reader.header.names
        active: Dict[str, List[int]] = {c: [] for c in by_chrom}
        nxt: Dict[str, int] = {c: 0 for c in by_chrom}
        for rec in reader:
            if not rec.is_primary or rec.mapq < cfg.min_mapq:
                continue
            chrom = names[rec.tid]
            if chrom not in by_chrom:
                continue
            rec_end = rec.end_pos()
            lst = by_chrom[chrom]
            # activate clusters whose region begins before rec_end
            # (htslib region [min_s-1, max_e) 0-based, clusterer.cpp:524)
            while (nxt[chrom] < len(lst)
                   and clusters[lst[nxt[chrom]]].s - 1 < rec_end):
                active[chrom].append(lst[nxt[chrom]])
                nxt[chrom] += 1
            # retire clusters entirely before this record
            active[chrom] = [ci for ci in active[chrom]
                             if clusters[ci].e >= rec.pos]
            if not active[chrom]:
                continue
            alp = None
            for ci in active[chrom]:
                cl = clusters[ci]
                if not (rec.pos < cl.e and rec_end > cl.s - 1):
                    continue
                reads, coverages, locus_reads = meta[ci]
                hp = rec.get_tag("HP", 0) or 0
                coverages[hp if hp in (1, 2) else 0] += 1
                locus_reads.append((0, 3 if hp == 0 else hp))
                if rec.qname not in reads:
                    continue
                locus_reads[-1] = (1, locus_reads[-1][1])
                if alp is None:
                    aq2, ar2 = aligned_pairs_arrays(rec)
                    v2 = (aq2 != -1) & (ar2 != -1)
                    alp = (aq2[v2], ar2[v2])
                vq2, vr2 = alp
                # last placed pair with r <= cluster start / first with
                # r >= cluster end (clusterer.cpp:562-585, via searchsorted
                # over the monotone placed ref positions)
                qs = -1
                qe = -1
                i0 = int(np.searchsorted(vr2, cl.s, "right")) - 1
                if i0 >= 0:
                    qs = int(vq2[i0])
                i1 = int(np.searchsorted(vr2, cl.e, "left"))
                if i1 < len(vq2):
                    qe = int(vq2[i1])
                if qs == -1 or qe == -1:
                    stats.unextended += 1
                else:
                    cl.add_subread(rec.qname, rec.seq[qs:qe + 1], hp)
    for ci in live:
        cluster = clusters[ci]
        reads, coverages, locus_reads = meta[ci]
        if cluster.size() >= cfg.min_cluster_weight:
            cluster.set_cov(coverages)
            cluster.set_reads(locus_reads)
        else:
            stats.small_clusters_2 += 1


# ---------------------------------------------------------------- calling

def split_cluster_by_len(cluster: Cluster, cfg: Config) -> List[Cluster]:
    """caller.cpp:78-97."""
    subclusters: List[Cluster] = []
    for sr in cluster.subreads:
        placed = False
        for sub in subclusters:
            cl = float(sub.get_len())
            sl = float(sr.size())
            if min(cl, sl) / max(cl, sl) >= cfg.min_ratio:
                sub.add_subread(sr)
                placed = True
                break
        if not placed:
            nc = cluster.shallow_copy_meta()
            nc.add_subread(sr)
            subclusters.append(nc)
    return subclusters


def split_cluster(cluster: Cluster, cfg: Config) -> List[Cluster]:
    """caller.cpp:100-255 — split by haplotype tag, then length; keep the
    top subcluster per haplotype (top-2 by size when untagged).

    Reproduces the reference's `int best_ratio` truncation
    (caller.cpp:158-179): after the first qualifying subcluster, any later
    qualifying one wins ('last wins'), and an untagged subread qualifying
    for *both* haplotypes joins neither (0 > 0 is false both ways)."""
    c0 = cluster.shallow_copy_meta()
    c1 = cluster.shallow_copy_meta()
    c2 = cluster.shallow_copy_meta()
    for sr in cluster.subreads:
        if cfg.useht:
            if sr.htag == 1:
                c1.add_subread(sr)
            elif sr.htag == 2:
                c2.add_subread(sr)
            else:
                c0.add_subread(sr)
        else:
            c0.add_subread(sr)
    c0.cov1 = c0.cov2 = -1
    c1.cov0 = c1.cov2 = -1
    c2.cov0 = c2.cov1 = -1

    out: List[Cluster] = []
    if c1.size() == 0 and c2.size() == 0:
        subclusters = split_cluster_by_len(c0, cfg)
        i1 = i2 = -1
        v1 = v2 = 0
        for i, sub in enumerate(subclusters):
            if sub.size() > v1:
                v2, i2 = v1, i1
                v1, i1 = sub.size(), i
            elif sub.size() > v2:
                v2, i2 = sub.size(), i
        if i1 != -1:
            out.append(subclusters[i1])
        if i2 != -1:
            out.append(subclusters[i2])
    else:
        both = (1 if c1.size() > 0 else 0) + (2 if c2.size() > 0 else 0)
        subs1 = split_cluster_by_len(c1, cfg)
        subs2 = split_cluster_by_len(c2, cfg)
        new_cluster = Cluster(chrom=cluster.chrom, s=cluster.s, e=cluster.e,
                              cov=cluster.cov, cov0=cluster.cov0,
                              cov1=-1, cov2=-1)
        for sr in c0.subreads:
            sl = float(sr.size())
            best_1, best_ratio_1 = -1, -1
            for i, sub in enumerate(subs1):
                clen = float(sub.get_len())
                r = min(clen, sl) / max(clen, sl)
                if r >= cfg.min_ratio and r > best_ratio_1:
                    best_1 = i
                    best_ratio_1 = int(r)   # int truncation quirk
            best_2, best_ratio_2 = -1, -1
            for i, sub in enumerate(subs2):
                clen = float(sub.get_len())
                r = min(clen, sl) / max(clen, sl)
                if r >= cfg.min_ratio and r > best_ratio_2:
                    best_2 = i
                    best_ratio_2 = int(r)
            if both == 1:
                if best_1 == -1:
                    new_cluster.add_subread(sr)
                else:
                    subs1[best_1].add_subread(sr)
                    subs1[best_1].cov1 += 1
                    new_cluster.cov0 -= 1
            elif both == 2:
                if best_2 == -1:
                    new_cluster.add_subread(sr)
                else:
                    subs2[best_2].add_subread(sr)
                    subs2[best_2].cov2 += 1
                    new_cluster.cov0 -= 1
            else:
                if best_1 != -1 and best_ratio_1 > best_ratio_2:
                    subs1[best_1].add_subread(sr)
                    subs1[best_1].cov1 += 1
                    new_cluster.cov0 -= 1
                elif best_2 != -1 and best_ratio_2 > best_ratio_1:
                    subs2[best_2].add_subread(sr)
                    subs2[best_2].cov2 += 1
                    new_cluster.cov0 -= 1

        for subs in (subs1, subs2):
            v_max, i_max = 0, -1
            for i, sub in enumerate(subs):
                if sub.size() > v_max:
                    v_max, i_max = sub.size(), i
            if i_max != -1:
                out.append(subs[i_max])
        if both != 3:
            new_subs = split_cluster_by_len(new_cluster, cfg)
            v_max, i_max = 0, -1
            for i, sub in enumerate(new_subs):
                if sub.size() > v_max:
                    v_max, i_max = sub.size(), i
            if i_max != -1:
                if both == 1:
                    new_subs[i_max].cov1 = -1
                else:
                    new_subs[i_max].cov2 = -1
                out.append(new_subs[i_max])
    assert 0 < len(out) <= 2
    return out


_CALL_PARAMS = AlignParams()  # caller.cpp:333-337 scores


def _emit_cluster_svs(cluster: Cluster, cl: Cluster, consensus: str,
                      score: int, cigar, chroms: Dict[str, str],
                      cfg: Config, svs: List[SV],
                      consensuses: List[Consensus]) -> None:
    """CIGAR walk emitting INS/DEL >= min_sv_length (caller.cpp:360-404)."""
    chrom = cl.chrom
    chrom_seq = chroms[chrom]
    cigar_str = "".join(f"{ln}{op}" for ln, op in cigar)
    consensuses.append(Consensus(consensus, cigar_str, chrom, cl.s, cl.e))
    rpos = cl.s
    cpos = 0
    nv = 0
    _svs: List[SV] = []
    for ln, op in cigar:
        if op in ("=", "M"):
            rpos += ln
            cpos += ln
        elif op == "I":
            if ln >= cfg.min_sv_length:
                sv = SV("INS", chrom, rpos,
                        chrom_seq[rpos - 1:rpos],
                        chrom_seq[rpos - 1:rpos] + consensus[cpos:cpos + ln],
                        cl.size(), cl.cov, nv, score, False, ln, cigar_str)
                sv.add_reads(cl.get_names())
                _svs.append(sv)
                nv += 1
            cpos += ln
        elif op == "D":
            if ln >= cfg.min_sv_length:
                sv = SV("DEL", chrom, rpos,
                        chrom_seq[rpos - 1:rpos + ln],
                        chrom_seq[rpos - 1:rpos],
                        cl.size(), cl.cov, nv, score, False, ln, cigar_str)
                sv.add_reads(cl.get_names())
                _svs.append(sv)
                nv += 1
            rpos += ln
    for sv in _svs:
        sv.ngaps = nv
        sv.set_gt("0/1", 100)
        sv.set_cov(cl.cov, cl.cov0, cl.cov1, cl.cov2)
        sv.set_rvec(cluster.reads)
    svs.extend(_svs)


def call_cluster(cluster: Cluster, chroms: Dict[str, str], cfg: Config
                 ) -> Tuple[List[SV], List[Consensus]]:
    """POA + realignment + CIGAR walk for one cluster (caller.cpp:313-405)."""
    from ..utils.seq import encode_nt6
    svs: List[SV] = []
    consensuses: List[Consensus] = []
    chrom_seq = chroms[cluster.chrom]
    for cl in split_cluster(cluster, cfg):
        ref = chrom_seq[cl.s:cl.e + 1]
        consensus = poa_consensus(cl.get_seqs())
        if not consensus:
            continue
        score, cigar = align_dual_gap(encode_nt6(consensus), encode_nt6(ref),
                                      _CALL_PARAMS)
        _emit_cluster_svs(cluster, cl, consensus, score, cigar, chroms,
                          cfg, svs, consensuses)
    return svs, consensuses



def pcall(clusters: List[Cluster], chroms: Dict[str, str], cfg: Config,
          device=None) -> Tuple[List[SV], List[Consensus]]:
    """Call SVs over all weighted clusters.

    Host path: cluster-by-cluster (call_cluster). Device path
    (cfg.use_device): split + POA consensus on host, then all
    consensus-vs-reference alignments batched onto the wavefront DP
    (ops/align_dp.py: kernel K1 on the card) on `device` (cuda unless
    asked otherwise), bucketed by padded size."""
    svs: List[SV] = []
    cons: List[Consensus] = []
    live = [c for c in clusters if c.size() >= cfg.min_cluster_weight]
    if not cfg.use_device:
        for cluster in live:
            s, c = call_cluster(cluster, chroms, cfg)
            svs.extend(s)
            cons.extend(c)
        return svs, cons

    from concurrent.futures import ThreadPoolExecutor

    from ..ops.align_dp import batch_align
    from ..utils.device import resolve_device
    from ..utils.seq import encode_nt6
    device = resolve_device(device)
    # phase 1: split + POA consensus per subcluster (host, thread pool —
    # the reference's omp-over-clusters, caller.cpp:312)
    subtasks = []
    for cluster in live:
        chrom_seq = chroms[cluster.chrom]
        for cl in split_cluster(cluster, cfg):
            ref = chrom_seq[cl.s:cl.e + 1]
            subtasks.append((cluster, cl, ref))
    seq_lists = [t[1].get_seqs() for t in subtasks]
    from ..ops.poa_native import poa_consensus_batch
    consensuses = poa_consensus_batch(seq_lists,
                                      threads=max(cfg.threads, 1))
    if consensuses is None:
        # native library absent: Python oracle over a thread pool
        with ThreadPoolExecutor(max_workers=max(cfg.threads, 1)) as pool:
            consensuses = list(pool.map(poa_consensus, seq_lists))
    tasks = [(cluster, cl, consensus, ref)
             for (cluster, cl, ref), consensus in zip(subtasks, consensuses)
             if consensus]

    def bucket(n: int) -> int:
        b = 256
        while b < n:
            b *= 2
        return b

    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (_, _, consensus, ref) in enumerate(tasks):
        groups.setdefault((bucket(len(consensus)), bucket(len(ref))),
                          []).append(i)
    results: Dict[int, Tuple[int, list]] = {}
    # chunk each bucket: the trace buffer is O(B * (bq+bt) * bq) bytes,
    # cap at ~256MB per launch
    for (bq, bt), idxs in groups.items():
        chunk = max(8, min(128, (256 << 20) // ((bq + bt) * (bq + 1))))
        for c0 in range(0, len(idxs), chunk):
            part = idxs[c0:c0 + chunk]
            pairs = [(encode_nt6(tasks[i][2]).astype(np.int32),
                      encode_nt6(tasks[i][3]).astype(np.int32))
                     for i in part]
            for i, res in zip(part, batch_align(pairs, _CALL_PARAMS,
                                                pad_q=bq, pad_t=bt,
                                                device=device)):
                results[i] = res
    for i, (cluster, cl, consensus, _ref) in enumerate(tasks):
        score, cigar = results[i]
        _emit_cluster_svs(cluster, cl, consensus, score, cigar, chroms,
                          cfg, svs, cons)
    return svs, cons


# ---------------------------------------------------------------- filtering

def clean_dups(svs: List[SV]) -> List[SV]:
    """Remove consecutive exact duplicates (caller.cpp:409-426)."""
    out: List[SV] = []
    last = (None, None, None, None)
    for sv in svs:
        key = (sv.chrom, sv.s, sv.refall, sv.altall)
        if key != last:
            out.append(sv)
        last = key
    return out


def indel_similarity(a: str, b: str) -> float:
    """rapidfuzz fuzz::ratio equivalent: 100 * (1 - indel_dist/(|a|+|b|))."""
    if not a and not b:
        return 100.0
    la, lb = len(a), len(b)
    bb = np.frombuffer(b.encode(), dtype=np.uint8)
    jj = np.arange(lb + 1, dtype=np.int32)
    prev = jj.copy()
    for i in range(1, la + 1):
        ca = ord(a[i - 1])
        cur = np.empty(lb + 1, dtype=np.int32)
        cur[0] = i
        # indel distance (no substitutions): diagonal only on equal chars
        diag = np.where(bb == ca, prev[:-1], np.int32(10 ** 9))
        cur[1:] = np.minimum(diag, prev[1:] + 1)
        # exact left-to-right relaxation cur[j] = min_k<=j cur[k] + (j - k)
        # via a min-plus prefix scan
        cur = np.minimum.accumulate(cur - jj) + jj
        prev = cur
    dist = int(prev[lb])
    return 100.0 * (1.0 - dist / (la + lb))


def filter_sv_chains(svs: List[SV], cfg: Config) -> List[SV]:
    """Merge nearby, similar-weight/length/sequence same-type SVs, keeping
    the heavier of each pair (caller.cpp:429-475)."""
    if len(svs) < 2:
        return list(svs)
    out: List[SV] = []
    prev = svs[0]
    reset = False
    for i in range(1, len(svs)):
        if reset:
            reset = False
            prev = svs[i]
            continue
        sv = svs[i]
        if (sv.chrom == prev.chrom and sv.s - prev.e < 2 * sv.l
                and prev.type == sv.type):
            w_r = min(sv.w, prev.w) / max(sv.w, prev.w)
            l_r = min(sv.l, prev.l) / max(sv.l, prev.l)
            d = sv.s - prev.s
            if (d < cfg.chain_merge_distance and w_r >= cfg.chain_weight_ratio
                    and l_r >= cfg.min_ratio):
                if sv.type == "DEL":
                    sim = indel_similarity(sv.refall, prev.refall)
                else:
                    sim = indel_similarity(sv.altall, prev.altall)
                if sim > cfg.chain_similarity:
                    out.append(sv if sv.w > prev.w else prev)
                    reset = True
                    continue
        out.append(prev)
        prev = sv
    if not reset:
        out.append(prev)
    return out


# ---------------------------------------------------------------- driver

def store_clusters(path: str, clusters: List[Cluster]) -> None:
    """Dump clusters to a file (``--clusters``; store_clusters,
    clusterer.cpp:613-626: 1-based inclusive region, size, name:seq...)."""
    with open(path, "w") as fh:
        for cluster in clusters:
            fh.write(f"{cluster.chrom}:{cluster.s + 1}-{cluster.e + 1}"
                     f"\t{cluster.size()}")
            for sr in cluster.subreads:
                fh.write(f"\t{sr.name}:{sr.seq}")
            fh.write("\n")


def run_call(cfg: Config, chroms: Dict[str, str], bam_path: str,
             sfs_map: Dict[str, List[SFS]], out=None,
             clusters_out: Optional[str] = None, device=None
             ) -> Tuple[List[SV], List[Consensus], List[Clip]]:
    """Full call stage; returns (svs, poa_alignments, clips). With
    cfg.use_device the realignments run on `device` (cuda unless asked
    otherwise)."""
    if cfg.use_device:
        from ..utils.device import resolve_device
        device = resolve_device(device)     # fail before the host work
    t0 = time.time()
    stats = CallStats()
    # decompress the BAM once; both streaming passes parse from memory
    from ..io.bgzf import bgzf_inflate_all
    try:
        data = bgzf_inflate_all(bam_path)
    except IOError:
        data = None
    src = data if data is not None else bam_path
    extended, clips = align_and_extend(src, sfs_map, chroms, cfg, stats)
    logger.info("call: %d extended SFSs (%d/%d/%d unplaced, %d unknown, "
                "%d clips)", len(extended), stats.unplaced, stats.s_unplaced,
                stats.e_unplaced, stats.unknown, len(clips))
    clusters = cluster_by_proximity(extended, cfg)
    logger.info("call: %d clusters", len(clusters))
    fill_clusters(src, clusters, chroms, cfg, stats)
    logger.info("call: filtered %d SFSs, %d + %d small clusters",
                stats.unextended, stats.small_clusters,
                stats.small_clusters_2)
    if clusters_out:
        logger.info("call: storing clusters to %s", clusters_out)
        store_clusters(clusters_out, clusters)
    svs, cons = pcall(clusters, chroms, cfg, device)
    svs.sort(key=lambda s: s.sort_key())
    svs = clean_dups(svs)
    logger.info("call: %d SVs before chain filtering", len(svs))
    svs = filter_sv_chains(svs, cfg)
    svs.sort(key=lambda s: s.sort_key())
    logger.info("call: %d SVs in %.2fs", len(svs), time.time() - t0)
    if out is not None:
        from ..io.vcf import write_vcf
        write_vcf(out, chroms, svs)
    return svs, cons, clips
