"""BGZF (blocked gzip) codec.

BAM files are BGZF streams: a series of <=64KiB gzip members, each carrying a
``BC`` extra subfield with the compressed block size, terminated by a fixed
28-byte empty EOF block. The reference gets this from htslib (bgzf.h, used
throughout, e.g. ping_pong.cpp:249); this is our own host-side implementation.

A C++ accelerated codec (``native/``) can be swapped in transparently; this
pure-Python version is the portable fallback and the correctness oracle.
"""

from __future__ import annotations

import io
import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<4BI2BH")  # magic(2) method flags mtime xfl os xlen

MAX_BLOCK_DATA = 65280  # htslib uses 0xff00 to leave room for the wrapper


def bgzf_inflate_all(path: str, threads: int = 2) -> bytearray | None:
    """Whole-file BGZF decompression into one bytearray.

    Scans block headers (BC size field + ISIZE footers) to lay out the
    output, then inflates blocks on a small thread pool — zlib releases
    the GIL, and bytearray slice-assignment is a real memcpy (numpy
    buffer assignment measured ~50x slower at GB scale). Plays the role
    of htslib's bgzf_mt reader pool (ping_pong.cpp:249)."""
    from concurrent.futures import ThreadPoolExecutor
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return None
    metas = []
    off = 0
    total = 0
    n = len(raw)
    while off + 28 <= n:
        if raw[off] != 0x1F or raw[off + 1] != 0x8B:
            raise IOError("not a BGZF block")
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        isize = struct.unpack_from("<I", raw, off + bsize - 4)[0]
        if isize:
            metas.append((off + 12 + xlen, bsize - 12 - xlen - 8, total,
                          isize))
        total += isize
        off += bsize
    out = bytearray(total)

    def work(chunk):
        for coff, clen, uoff, ulen in chunk:
            out[uoff:uoff + ulen] = zlib.decompress(
                raw[coff:coff + clen], -15, ulen)

    if threads <= 1 or len(metas) < 64:
        work(metas)
    else:
        # contiguous ranges (strided splits thrash the output cache)
        step = (len(metas) + threads - 1) // threads
        parts = [metas[i:i + step] for i in range(0, len(metas), step)]
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(work, parts))
    return out


class BgzfReader(io.RawIOBase):
    """Sequential BGZF reader exposing a file-like read() interface.

    When the native library is built and a path is given, the whole file is
    decompressed up front with the parallel C++ inflater (the role htslib's
    bgzf_mt pool plays in the reference) and served from memory; set
    SVDSS_TPU_NO_NATIVE=1 to force the streaming pure-Python path."""

    def __init__(self, path_or_fh):
        import os as _os
        self._fh = None
        self._own = False
        self._buf = b""
        self._pos = 0
        self._eof = False
        if (isinstance(path_or_fh, (str, bytes))
                and not _os.environ.get("SVDSS_TPU_NO_NATIVE")):
            p = (path_or_fh if isinstance(path_or_fh, str)
                 else path_or_fh.decode())
            try:
                data = bgzf_inflate_all(p)
            except IOError:
                data = None
            if data is not None:
                self._buf = data
                self._eof = True
                return
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "rb")
            self._own = True
        else:
            self._fh = path_or_fh

    def _read_block(self) -> bytes | None:
        hdr = self._fh.read(12)
        if len(hdr) == 0:
            return None
        if len(hdr) < 12:
            raise IOError("truncated BGZF header")
        magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = \
            _HDR.unpack(hdr)
        if (magic1, magic2, method) != (0x1F, 0x8B, 8) or not flags & 4:
            raise IOError("not a BGZF block")
        extra = self._fh.read(xlen)
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = extra[off], extra[off + 1], \
                struct.unpack_from("<H", extra, off + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
            off += 4 + slen
        if bsize is None:
            raise IOError("BGZF block without BC subfield")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        crc, isize = struct.unpack("<II", self._fh.read(8))
        data = zlib.decompress(cdata, -15)
        if len(data) != isize:
            raise IOError("BGZF block ISIZE mismatch")
        if zlib.crc32(data) & 0xFFFFFFFF != crc:
            raise IOError("BGZF block CRC mismatch")
        return data

    def read(self, n: int = -1) -> bytes:
        if self._eof and self._fh is None:
            # in-memory fast path: return (zero-copy) slices
            if n < 0:
                chunk = self._buf[self._pos:]
                self._pos = len(self._buf)
            else:
                chunk = self._buf[self._pos:self._pos + n]
                self._pos += len(chunk)
            return chunk
        if n < 0:
            chunks = [self._buf[self._pos:]]
            self._buf, self._pos = b"", 0
            while not self._eof:
                blk = self._read_block()
                if blk is None:
                    self._eof = True
                else:
                    chunks.append(blk)
            return b"".join(chunks)
        out = []
        need = n
        while need > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                if self._eof:
                    break
                blk = self._read_block()
                if blk is None:
                    self._eof = True
                    break
                self._buf, self._pos = blk, 0
                continue
            take = min(avail, need)
            out.append(self._buf[self._pos:self._pos + take])
            self._pos += take
            need -= take
        return b"".join(out)

    def close(self) -> None:
        if self._own and self._fh is not None:
            self._fh.close()
        super().close()


class BgzfWriter(io.RawIOBase):
    """BGZF writer; emits <=64KiB members + the standard EOF block."""

    def __init__(self, path_or_fh, level: int = 6):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "wb")
            self._own = True
        else:
            self._fh = path_or_fh
            self._own = False
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_DATA:
            self._flush_block(bytes(self._buf[:MAX_BLOCK_DATA]))
            del self._buf[:MAX_BLOCK_DATA]
        return len(data)

    def _flush_block(self, data: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        bsize = len(cdata) + 25  # total block size (hdr 12 + extra 6 + crc/isize 8) minus 1
        block = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                 + struct.pack("<H", 6)
                 + b"BC" + struct.pack("<HH", 2, bsize)
                 + cdata
                 + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                               len(data)))
        self._fh.write(block)

    def close(self) -> None:
        if self.closed:
            return
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf = bytearray()
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()
        super().close()
