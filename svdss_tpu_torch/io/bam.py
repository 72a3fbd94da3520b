"""BAM record codec and CIGAR utilities.

Our own host-side implementation of the subset of htslib the reference uses:
sequential read (``sam_read1``), write (``sam_write1``), aux-tag access
(``bam_aux_get``/``bam_aux_update_int`` for HP/XF), CIGAR decode/encode and
pysam-style aligned pairs (reference bam.cpp:25-134).

Random-access regional queries (htslib ``sam_itr_querys``, used by
clusterer.cpp:524-527) are deliberately replaced by a single streaming pass
over position-sorted records (`svdss_tpu.pipeline.call`), which avoids the
.bai index format entirely and reads the file once instead of once per
cluster.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .bgzf import BgzfReader, BgzfWriter
from ..utils.seq import NT16_STR, NT16_TABLE

_NT16_BYTES = np.frombuffer(NT16_STR.encode(), dtype=np.uint8)

# BAM flags (htslib sam.h)
FPAIRED = 1
FUNMAP = 4
FREVERSE = 16
FSECONDARY = 256
FQCFAIL = 512
FDUP = 1024
FSUPPLEMENTARY = 2048

# CIGAR op codes (htslib sam.h): M I D N S H P = X
CIGAR_OPS = "MIDNSHP=X"
BAM_CMATCH, BAM_CINS, BAM_CDEL, BAM_CREF_SKIP, BAM_CSOFT_CLIP, \
    BAM_CHARD_CLIP, BAM_CPAD, BAM_CEQUAL, BAM_CDIFF = range(9)

_CONSUME_QUERY = (True, True, False, False, True, False, False, True, True)
_CONSUME_REF = (True, False, True, True, False, False, False, True, True)


class BamHeader:
    def __init__(self, text: str, refs: List[Tuple[str, int]]):
        self.text = text
        self.refs = refs                      # [(name, length)]
        self.names = [n for n, _ in refs]

    @classmethod
    def from_refs(cls, refs: List[Tuple[str, int]],
                  extra_text: str = "") -> "BamHeader":
        text = "@HD\tVN:1.6\tSO:coordinate\n"
        for name, length in refs:
            text += f"@SQ\tSN:{name}\tLN:{length}\n"
        text += extra_text
        return cls(text, list(refs))


class BamRecord:
    """One alignment record.

    seq/qual/aux decode lazily when the record came from a reader (they are
    by far the heaviest fields; most pipeline passes only touch
    flag/pos/cigar/qname). `l_seq` is always available without decoding.
    """

    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar",
                 "_seq", "_qual", "_aux", "mtid", "mpos", "tlen", "_bin",
                 "l_seq", "_raw", "_seq_off", "_raw_lseq")

    def __init__(self, qname: str, flag: int, tid: int, pos: int, mapq: int,
                 cigar: List[Tuple[int, int]], seq: str, qual: bytes,
                 aux: Optional[List[Tuple[str, str, object]]] = None,
                 mtid: int = -1, mpos: int = -1, tlen: int = 0):
        self.qname = qname
        self.flag = flag
        self.tid = tid
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar    # [(length, opcode)] — order matches decode_cigar (bam.cpp:25)
        self._seq = seq
        self._qual = qual
        self._aux = aux or []  # [(tag, typechar, value)]
        self.l_seq = len(seq)
        self.mtid = mtid
        self.mpos = mpos
        self.tlen = tlen
        self._bin = 0
        self._raw = None
        self._seq_off = 0
        self._raw_lseq = 0

    # -- lazy heavy fields -------------------------------------------------
    @property
    def seq(self) -> str:
        if self._seq is None:
            off = self._seq_off
            nbytes = (self._raw_lseq + 1) // 2
            packed = np.frombuffer(self._raw, dtype=np.uint8, count=nbytes,
                                   offset=off)
            nibs = np.empty(nbytes * 2, dtype=np.uint8)
            nibs[0::2] = packed >> 4
            nibs[1::2] = packed & 0xF
            self._seq = _NT16_BYTES[nibs[:self._raw_lseq]].tobytes().decode()
        return self._seq

    @seq.setter
    def seq(self, v: str) -> None:
        self._seq = v
        self.l_seq = len(v)

    @property
    def qual(self) -> bytes:
        if self._qual is None:
            off = self._seq_off + (self._raw_lseq + 1) // 2
            self._qual = bytes(self._raw[off:off + self._raw_lseq])
        return self._qual

    @qual.setter
    def qual(self, v: bytes) -> None:
        self._qual = v

    @property
    def aux(self) -> List[Tuple[str, str, object]]:
        if self._aux is None:
            off = (self._seq_off + (self._raw_lseq + 1) // 2
                   + self._raw_lseq)
            self._aux = _parse_aux(self._raw[off:])
        return self._aux

    @aux.setter
    def aux(self, v) -> None:
        self._aux = v or []

    # -- convenience -------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_primary(self) -> bool:
        return not self.flag & (FUNMAP | FSECONDARY | FSUPPLEMENTARY)

    def get_tag(self, tag: str, default=None):
        for t, _ty, v in self.aux:
            if t == tag:
                return v
        return default

    def set_tag(self, tag: str, typechar: str, value) -> None:
        for i, (t, _ty, _v) in enumerate(self.aux):
            if t == tag:
                self.aux[i] = (tag, typechar, value)
                return
        self.aux.append((tag, typechar, value))

    def end_pos(self) -> int:
        """Reference end (exclusive), like htslib bam_endpos."""
        r = self.pos
        for ln, op in self.cigar:
            if _CONSUME_REF[op]:
                r += ln
        return r

    def cigar_str(self) -> str:
        return "".join(f"{ln}{CIGAR_OPS[op]}" for ln, op in self.cigar)


def aligned_pairs_arrays(rec: BamRecord) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized aligned pairs: (query_pos, ref_pos) int32 arrays with -1
    gaps — same expansion as `aligned_pairs` (bam.cpp:92-134) without the
    per-base Python loop."""
    qs_parts = []
    rs_parts = []
    r = rec.pos
    q = 0
    for ln, op in rec.cigar:
        if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
            qs_parts.append(np.arange(q, q + ln, dtype=np.int32))
            rs_parts.append(np.arange(r, r + ln, dtype=np.int32))
            q += ln
            r += ln
        elif op in (BAM_CINS, BAM_CSOFT_CLIP):
            qs_parts.append(np.arange(q, q + ln, dtype=np.int32))
            rs_parts.append(np.full(ln, -1, dtype=np.int32))
            q += ln
        elif op in (BAM_CDEL, BAM_CREF_SKIP):
            qs_parts.append(np.full(ln, -1, dtype=np.int32))
            rs_parts.append(np.arange(r, r + ln, dtype=np.int32))
            r += ln
        # H / P: advance neither
    if not qs_parts:
        z = np.empty(0, dtype=np.int32)
        return z, z
    return np.concatenate(qs_parts), np.concatenate(rs_parts)


def aligned_pairs(rec: BamRecord) -> List[Tuple[int, int]]:
    """(query_pos, ref_pos) pairs with -1 for gaps.

    Byte-for-byte the reference ``get_aligned_pairs`` (bam.cpp:92-134):
    M/=/X emit (q, r); I and S emit (q, -1); D and N emit (-1, r); H and P
    advance neither.
    """
    aq, ar = aligned_pairs_arrays(rec)
    return list(zip(aq.tolist(), ar.tolist()))


# -- aux tag (de)serialization --------------------------------------------

_AUX_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I",
            "f": "<f", "A": "<c"}


def _parse_aux(data: bytes) -> List[Tuple[str, str, object]]:
    out = []
    off = 0
    n = len(data)
    while off + 3 <= n:
        tag = data[off:off + 2].decode()
        ty = chr(data[off + 2])
        off += 3
        if ty in "cCsSiIf":
            fmt = _AUX_FMT[ty]
            val = struct.unpack_from(fmt, data, off)[0]
            off += struct.calcsize(fmt)
        elif ty == "A":
            val = chr(data[off])
            off += 1
        elif ty in "ZH":
            end = data.index(b"\x00", off)
            val = data[off:end].decode()
            off = end + 1
        elif ty == "B":
            sub = chr(data[off])
            cnt = struct.unpack_from("<I", data, off + 1)[0]
            fmt = _AUX_FMT[sub]
            sz = struct.calcsize(fmt)
            vals = [struct.unpack_from(fmt, data, off + 5 + i * sz)[0]
                    for i in range(cnt)]
            val = (sub, vals)
            off += 5 + cnt * sz
        else:
            raise IOError(f"unknown aux type {ty!r} for tag {tag}")
        out.append((tag, ty, val))
    return out


def _encode_aux(aux: List[Tuple[str, str, object]]) -> bytes:
    parts = []
    for tag, ty, val in aux:
        head = tag.encode() + ty.encode()
        if ty in "cCsSiIf":
            parts.append(head + struct.pack(_AUX_FMT[ty], val))
        elif ty == "A":
            parts.append(head + val.encode())
        elif ty in "ZH":
            parts.append(head + val.encode() + b"\x00")
        elif ty == "B":
            sub, vals = val
            fmt = _AUX_FMT[sub]
            parts.append(head + sub.encode() + struct.pack("<I", len(vals))
                         + b"".join(struct.pack(fmt, v) for v in vals))
        else:
            raise IOError(f"unknown aux type {ty!r} for tag {tag}")
    return b"".join(parts)


# -- record (de)serialization ---------------------------------------------

def _decode_record(data: bytes) -> BamRecord:
    """Parse the cheap fixed fields eagerly; defer seq/qual/aux."""
    (tid, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    qname = data[off:off + l_qname - 1].split(b"\x00", 1)[0].decode()
    off += l_qname
    if n_cigar:
        carr = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=off)
        cigar = list(zip((carr >> 4).tolist(), (carr & 0xF).tolist()))
    else:
        cigar = []
    off += 4 * n_cigar
    rec = BamRecord(qname, flag, tid, pos, mapq, cigar, "", b"",
                    None, mtid, mpos, tlen)
    rec._bin = _bin
    rec.l_seq = l_seq
    rec._raw_lseq = l_seq
    rec._raw = data
    rec._seq_off = off
    rec._seq = None if l_seq else ""
    rec._qual = None if l_seq else b""
    rec._aux = None
    return rec


def _encode_record(rec: BamRecord) -> bytes:
    l_seq = len(rec.seq)
    qname_b = rec.qname.encode() + b"\x00"
    cigar_b = b"".join(struct.pack("<I", (ln << 4) | op)
                       for ln, op in rec.cigar)
    if l_seq:
        nibs = NT16_TABLE[np.frombuffer(rec.seq.encode(), dtype=np.uint8)]
        if l_seq % 2:
            nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
        seq_b = ((nibs[0::2] << 4) | nibs[1::2]).astype(np.uint8).tobytes()
    else:
        seq_b = b""
    qual = rec.qual if len(rec.qual) == l_seq else b"\xff" * l_seq
    aux_b = _encode_aux(rec.aux)
    body = struct.pack("<iiBBHHHiiii", rec.tid, rec.pos, len(qname_b),
                       rec.mapq, rec._bin, len(rec.cigar), rec.flag, l_seq,
                       rec.mtid, rec.mpos, rec.tlen)
    return body + qname_b + cigar_b + bytes(seq_b) + qual + aux_b


class BamReader:
    """Sequential BAM reader over a path or pre-decompressed bytes."""

    def __init__(self, path):
        if isinstance(path, (bytes, bytearray, memoryview)):
            import io as _io
            gz = BgzfReader.__new__(BgzfReader)
            _io.RawIOBase.__init__(gz)
            gz._fh = None
            gz._own = False
            gz._buf = path
            gz._pos = 0
            gz._eof = True
            self._gz = gz
        else:
            self._gz = BgzfReader(path)
        magic = self._gz.read(4)
        if magic != b"BAM\x01":
            raise IOError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._gz.read(4))[0]
        text = bytes(self._gz.read(l_text)).split(b"\x00", 1)[0].decode()
        n_ref = struct.unpack("<i", self._gz.read(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._gz.read(4))[0]
            name = bytes(self._gz.read(l_name))[:-1].decode()
            l_ref = struct.unpack("<i", self._gz.read(4))[0]
            refs.append((name, l_ref))
        self.header = BamHeader(text, refs)

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            szb = self._gz.read(4)
            if len(szb) < 4:
                return
            block_size = struct.unpack("<i", szb)[0]
            data = self._gz.read(block_size)
            if len(data) < block_size:
                raise IOError("truncated BAM record")
            if isinstance(data, memoryview):
                data = bytes(data)
            yield _decode_record(data)

    def close(self) -> None:
        self._gz.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    def __init__(self, path: str, header: BamHeader, level: int = 6):
        self._gz = BgzfWriter(path, level=level)
        text_b = header.text.encode()
        self._gz.write(b"BAM\x01" + struct.pack("<i", len(text_b)) + text_b)
        self._gz.write(struct.pack("<i", len(header.refs)))
        for name, length in header.refs:
            nb = name.encode() + b"\x00"
            self._gz.write(struct.pack("<i", len(nb)) + nb
                           + struct.pack("<i", length))

    def write(self, rec: BamRecord) -> None:
        data = _encode_record(rec)
        self._gz.write(struct.pack("<i", len(data)) + data)

    def close(self) -> None:
        self._gz.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
