"""Synthetic genome / read / BAM simulation for tests and benchmarks.

The reference repo tests against a downloaded chr22 HiFi example
(tests/README.md:1-21); this environment has no network, so the correctness
harness simulates its own data: a random genome, donor haplotypes carrying
known SV insertions/deletions, and HiFi-like reads with SNV + small-indel
errors, emitted as a position-sorted BAM with exact CIGARs (what a mapper
would ideally produce). The known SV truth set is the end-to-end oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..io.bam import BamHeader, BamRecord, BamWriter, FREVERSE
from ..io.bam import BAM_CMATCH, BAM_CINS, BAM_CDEL, BAM_CSOFT_CLIP  # noqa: F401

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator,
                  sizes: Dict[str, int]) -> Dict[str, str]:
    return {name: BASES[rng.integers(0, 4, size)].tobytes().decode()
            for name, size in sizes.items()}


@dataclasses.dataclass
class TrueSV:
    type: str      # "INS" | "DEL"
    chrom: str
    pos: int       # reference position of the base *before* the event
    length: int
    seq: str = ""  # inserted sequence for INS


@dataclasses.dataclass
class Haplotype:
    """Donor haplotype = reference + SV edit script.

    Internally a list of segments, each either a reference span
    ("M", ref_start, ref_end) or an insertion ("I", ref_pos, seq).
    """
    chrom: str
    ref: str
    segments: List[Tuple]          # ("M", s, e) | ("I", pos, seq)
    svs: List[TrueSV]

    _seq_cache: str = None

    @property
    def seq(self) -> str:
        if self._seq_cache is None:
            parts = []
            for seg in self.segments:
                if seg[0] == "M":
                    parts.append(self.ref[seg[1]:seg[2]])
                else:
                    parts.append(seg[2])
            self._seq_cache = "".join(parts)
        return self._seq_cache

    def coord_map(self) -> List[Tuple[int, int, int]]:
        """[(donor_start, length, ref_start_or_-1)] per segment."""
        out = []
        d = 0
        for seg in self.segments:
            if seg[0] == "M":
                ln = seg[2] - seg[1]
                out.append((d, ln, seg[1]))
            else:
                ln = len(seg[2])
                out.append((d, ln, -1))
            d += ln
        return out


def make_haplotype(rng: np.random.Generator, chrom: str, ref: str,
                   n_ins: int, n_del: int, min_len: int = 50,
                   max_len: int = 400, margin: int = 2000) -> Haplotype:
    """Plant non-overlapping INS/DEL SVs into a reference chromosome."""
    n = len(ref)
    events = []
    taken: List[Tuple[int, int]] = []

    def place(span: int) -> int:
        for _ in range(1000):
            p = int(rng.integers(margin, n - margin - span))
            if all(p + span + 500 < s or p > e + 500 for s, e in taken):
                taken.append((p, p + span))
                return p
        raise RuntimeError("could not place SV")

    for _ in range(n_del):
        ln = int(rng.integers(min_len, max_len + 1))
        p = place(ln)
        events.append(("DEL", p, ln, ""))
    for _ in range(n_ins):
        ln = int(rng.integers(min_len, max_len + 1))
        p = place(0)
        ins = BASES[rng.integers(0, 4, ln)].tobytes().decode()
        events.append(("INS", p, ln, ins))
    events.sort(key=lambda e: e[1])

    segments: List[Tuple] = []
    svs: List[TrueSV] = []
    cur = 0
    for etype, p, ln, ins in events:
        segments.append(("M", cur, p))
        if etype == "DEL":
            svs.append(TrueSV("DEL", chrom, p - 1, ln))
            cur = p + ln
        else:
            segments.append(("I", p, ins))
            svs.append(TrueSV("INS", chrom, p - 1, ln, ins))
            cur = p
    segments.append(("M", cur, n))
    return Haplotype(chrom, ref, segments, svs)


_B2I = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _B2I[_b] = _i


def _donor_u8(hap: Haplotype) -> np.ndarray:
    """Donor sequence as a cached uint8 byte array (the str property
    stays for small-scale callers; per-read slicing at whole-genome
    read counts must not re-encode strings)."""
    arr = getattr(hap, "_u8_cache", None)
    if arr is None:
        arr = np.frombuffer(hap.seq.encode(), dtype=np.uint8)
        object.__setattr__(hap, "_u8_cache", arr)
    return arr


def _read_from_haplotype(rng: np.random.Generator, hap: Haplotype,
                         donor_start: int, read_len: int,
                         snv_rate: float, indel_rate: float,
                         max_small_indel: int = 10):
    """Extract a read and its CIGAR/ref-position vs the *reference*.

    Walks the haplotype edit script from donor_start: reference spans become
    M ops, SV insertions become I ops, SV deletions D ops. Then injects
    sequencing errors: SNVs inside M stretches and small I/D (errors only
    modify the read + CIGAR, mimicking a mapper's output). SNV injection
    is vectorized (fancy-indexed base rewrites) — the scalar per-base
    loop capped whole-genome simulation at ~4 MB/s.

    Returns (read_seq, ref_pos, cigar) or None if the read would start
    inside an insertion or run off the chromosome.
    """
    donor = _donor_u8(hap)
    if donor_start + read_len > len(donor):
        return None
    cmap = hap.coord_map()
    # locate the segment containing donor_start
    cigar: List[Tuple[int, int]] = []
    ref_pos = -1
    remaining = read_len
    pos = donor_start
    seg_i = 0
    while seg_i < len(cmap) and cmap[seg_i][0] + cmap[seg_i][1] <= pos:
        seg_i += 1
    first = True
    prev_ref_end = None
    while remaining > 0 and seg_i < len(cmap):
        d0, ln, r0 = cmap[seg_i]
        off = pos - d0
        take = min(ln - off, remaining)
        if r0 < 0:
            if first:
                return None  # starts inside an SV insertion; skip for simplicity
            cigar.append((take, BAM_CINS))
        else:
            seg_ref_start = r0 + off
            if first:
                ref_pos = seg_ref_start
                first = False
            elif prev_ref_end is not None and seg_ref_start > prev_ref_end:
                cigar.append((seg_ref_start - prev_ref_end, BAM_CDEL))
            prev_ref_end = seg_ref_start + take
            cigar.append((take, BAM_CMATCH))
        pos += take
        remaining -= take
        seg_i += 1
    if remaining > 0 or ref_pos < 0:
        return None
    read = donor[donor_start:donor_start + read_len]

    # inject sequencing errors (SNVs + small indels), rebuilding read+cigar
    out_seq: List[np.ndarray] = []
    out_cigar: List[Tuple[int, int]] = []
    qpos = 0

    def push(op_len: int, op: int) -> None:
        if op_len <= 0:
            return
        if out_cigar and out_cigar[-1][1] == op:
            out_cigar[-1] = (out_cigar[-1][0] + op_len, op)
        else:
            out_cigar.append((op_len, op))

    for op_len, op in cigar:
        if op != BAM_CMATCH:
            if op == BAM_CINS:
                out_seq.append(read[qpos:qpos + op_len])
                qpos += op_len
            push(op_len, op)
            continue
        # SNVs: substitute bases in place (stays an M op) — vectorized
        # old-base + 1..3 mod 4 draws uniformly from the three alts
        chunk = read[qpos:qpos + op_len].copy()
        nsnv = rng.binomial(op_len, snv_rate)
        if nsnv:
            idx = rng.integers(0, op_len, nsnv)
            alt = (_B2I[chunk[idx]] + rng.integers(1, 4, nsnv)) % 4
            chunk[idx] = BASES[alt]
        # small indels: split the M op
        nind = rng.binomial(op_len, indel_rate)
        cuts = sorted(int(c) for c in rng.integers(1, max(op_len, 2), nind))
        prev = 0
        for c in cuts:
            if c <= prev or c >= op_len:
                continue
            push(c - prev, BAM_CMATCH)
            out_seq.append(chunk[prev:c])
            ilen = int(rng.integers(1, max_small_indel + 1))
            if rng.random() < 0.5:
                out_seq.append(BASES[rng.integers(0, 4, ilen)])
                push(ilen, BAM_CINS)
            else:
                c2 = min(c + ilen, op_len)
                if c2 > c:
                    push(c2 - c, BAM_CDEL)
                    c = c2
            prev = c
        push(op_len - prev, BAM_CMATCH)
        out_seq.append(chunk[prev:op_len])
        qpos += op_len

    # a read ending inside an SV insertion would leave a trailing I op,
    # which a real mapper reports as a soft clip
    if out_cigar and out_cigar[-1][1] == BAM_CINS:
        out_cigar[-1] = (out_cigar[-1][0], BAM_CSOFT_CLIP)
    seq = np.concatenate(out_seq).tobytes().decode() if out_seq else ""
    return seq, ref_pos, out_cigar


def simulate_reads(rng: np.random.Generator, haplotypes: List[Haplotype],
                   coverage: float, read_len: int, snv_rate: float = 0.002,
                   indel_rate: float = 0.0005,
                   with_hp: bool = True) -> List[BamRecord]:
    """HiFi-like reads over the donor haplotypes as mapped BAM records."""
    records: List[BamRecord] = []
    idx = 0
    for hap_i, hap in enumerate(haplotypes):
        donor = hap.seq
        n_reads = int(len(donor) * coverage / len(haplotypes) / read_len)
        for _ in range(n_reads):
            start = int(rng.integers(0, max(1, len(donor) - read_len)))
            r = _read_from_haplotype(rng, hap, start, read_len,
                                     snv_rate, indel_rate)
            if r is None:
                continue
            seq, ref_pos, cigar = r
            aux = [("HP", "i", hap_i % 2 + 1)] if with_hp else []
            flag = FREVERSE if rng.random() < 0.5 else 0
            # NOTE: seq stored as aligned (forward) strand, as in a real BAM
            records.append(BamRecord(
                qname=f"read{idx}", flag=flag, tid=0, pos=ref_pos, mapq=60,
                cigar=cigar, seq=seq, qual=b"\x28" * len(seq), aux=aux))
            idx += 1
    records.sort(key=lambda rec: (rec.tid, rec.pos))
    return records


def write_bam(path: str, chroms: Dict[str, str],
              records: List[BamRecord], threads: int = 2) -> None:
    header = BamHeader.from_refs([(n, len(s)) for n, s in chroms.items()])
    from ..io.bam import _encode_record
    from ..io.native import bgzf_write_all
    from ..pipeline.smooth import _header_bytes
    import struct as _struct
    # fast path: encode the whole record stream, one parallel BGZF call
    # (the pure-Python single-thread level-6 deflate capped whole-genome
    # simulation); falls back to BamWriter when the .so is unavailable
    parts = [_header_bytes(header)]
    for rec in records:
        data = _encode_record(rec)
        parts.append(_struct.pack("<i", len(data)) + data)
    if bgzf_write_all(path, b"".join(parts), level=1,
                      n_threads=max(1, threads)):
        return
    with BamWriter(path, header) as w:
        for rec in records:
            w.write(rec)
