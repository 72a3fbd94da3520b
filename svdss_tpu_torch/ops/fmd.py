"""FMD index on the device (PyTorch), narrow mode (n < 2^31).

The device table is the JAX package's fused layout, row for row:

  ``fused`` int32[nblk, 48] — one 192-byte row per 128-symbol block, each
  row spanning 256 symbols (rows overlap; stride 128):
      cols  0..5  : occ checkpoint — count of each nt6 symbol in
                    BWT[0 : 128*b]
      cols  8..13 : order-prefix checkpoint — count of symbols whose
                    complement-order position ($, T, G, C, A, N) is < k
      cols 16..47 : BWT[128*b : 128*b + 256], 8 nibbles per int32 word,
                    interleaved: position p lives in word p % 32, nibble
                    p // 32
  ``C`` int32[8] — cumulative symbol counts.

An extension needs ranks at both interval endpoints (lo, hi = lo + sz);
because each row spans 256 symbols, both resolve from the one row at lo
whenever off(lo) + sz <= 256, and a wider extension takes a second step
that reads the row at hi (`extend_rank_step`).

The functions here are the plain PyTorch versions. The search hot loop
runs `extend_rank_step` inside the CUDA kernel of ``csrc/pingpong.cu``;
these serve the CPU path, the tests, and the kernel's on-card check.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.fmd import FMDIndex
from ..utils.device import resolve_device

# order position of each symbol in the fmd cumulative assignment:
# $=0, T=1, G=2, C=3, A=4, N=5 (complement-sorted appended symbols)
_ORD_NP = np.array([0, 4, 3, 2, 1, 5], dtype=np.int32)

DEV_BLOCK = 128
SPAN = 2 * DEV_BLOCK
LOG_BLOCK = 7
OCC_COLS = 16
BWT_WORDS = SPAN // 8
ROW_WORDS = OCC_COLS + BWT_WORDS


def fused_from_host(idx: FMDIndex) -> np.ndarray:
    """The fused [nblk, 48] int32 table of a narrow index, built in
    bounded-memory chunks."""
    nblk = idx.n // DEV_BLOCK + 1
    out = np.zeros((nblk, ROW_WORDS), dtype=np.int32)
    # one extra zero block so every row's 256-symbol span is in bounds
    sym_all = np.zeros((nblk + 1) * DEV_BLOCK, dtype=np.uint8)
    sym_all[: idx.n] = idx.bwt_symbols()
    blocks = sym_all.reshape(nblk + 1, DEV_BLOCK)
    per_block = np.zeros((nblk, 6), dtype=np.int64)
    shifts = np.arange(8, dtype=np.int64) * 4
    chunk = 1 << 17
    for start in range(0, nblk, chunk):
        stop = min(start + chunk, nblk)
        for c in range(6):
            per_block[start:stop, c] = (blocks[start:stop] == c).sum(axis=1)
        span = np.concatenate([blocks[start:stop],
                               blocks[start + 1:stop + 1]], axis=1)
        words = (span.reshape(stop - start, 8, BWT_WORDS).astype(np.int64)
                 << shifts[None, :, None]).sum(axis=1)
        out[start:stop, OCC_COLS:] = words.astype(np.int32)
    occ6 = np.zeros((nblk, 6), dtype=np.int64)
    occ6[1:] = np.cumsum(per_block, axis=0)[:-1]
    ord6_pre = np.zeros((nblk, 6), dtype=np.int64)
    for k in range(6):
        sel = [c for c in range(6) if _ORD_NP[c] < k]
        if sel:
            ord6_pre[:, k] = occ6[:, sel].sum(axis=1)
    out[:, :6] = occ6
    out[:, 8:14] = ord6_pre
    return out


class DeviceFMDIndex(NamedTuple):
    """FMD index resident in device memory (narrow mode)."""
    fused: torch.Tensor      # [nblk, 48] int32
    C: torch.Tensor          # [8] int32 cumulative counts

    @classmethod
    def from_host(cls, idx: FMDIndex, device=None) -> "DeviceFMDIndex":
        if idx.n >= 2**31:
            raise NotImplementedError(
                "wide-mode FMD tables (n >= 2^31) are not ported yet")
        return cls.from_arrays(fused_from_host(idx), idx.C, device)

    @classmethod
    def from_arrays(cls, fused: np.ndarray, C: np.ndarray,
                    device=None) -> "DeviceFMDIndex":
        """Wrap an existing fused table and C (e.g. the JAX package's
        DeviceFMDIndex arrays, so both engines read one table)."""
        dev = resolve_device(device)
        fused = np.ascontiguousarray(fused, dtype=np.int32)
        if not fused.flags.writeable:       # e.g. a view of a JAX array
            fused = fused.copy()
        C = np.asarray(C, dtype=np.int64)
        if fused.ndim != 2 or fused.shape[1] != ROW_WORDS:
            raise ValueError(f"fused must be [nblk, {ROW_WORDS}]")
        if C.shape != (8,) or C.max() >= 2**31:
            raise ValueError("C must be 8 counts below 2^31 (narrow mode)")
        return cls(fused=torch.from_numpy(fused).to(dev),
                   C=torch.from_numpy(C.astype(np.int32)).to(dev))

    @property
    def device(self) -> torch.device:
        return self.fused.device

    @property
    def nbytes(self) -> int:
        return self.fused.numel() * 4 + self.C.numel() * 4


def comp6(c: torch.Tensor) -> torch.Tensor:
    """nt6 complement (A<->T, C<->G; $ and N fixed)."""
    return torch.where((c >= 1) & (c <= 4), 5 - c, c)


def lookup_C(index: DeviceFMDIndex, c: torch.Tensor) -> torch.Tensor:
    """C[c] per lane (c in [0, 8))."""
    return index.C[c.long()]


def _unpack_rows(rows: torch.Tensor):
    """[R, 48] fused rows -> (occ [R, 16], sym [R, 256] int32), column c of
    sym being span position c."""
    occ = rows[:, :OCC_COLS]
    rep = rows[:, OCC_COLS:].repeat(1, 8)
    shifts = (torch.arange(SPAN, device=rows.device,
                           dtype=torch.int32) // BWT_WORDS) * 4
    return occ, (rep >> shifts) & 0xF


def rank6(index: DeviceFMDIndex, pos: torch.Tensor) -> torch.Tensor:
    """Counts of all 6 symbols in BWT[0:pos] for a batch of positions
    (pos [Q] int32, 0 <= pos <= n). Returns [Q, 6] int32."""
    occ, sym = _unpack_rows(index.fused[(pos >> LOG_BLOCK).long()])
    iota = torch.arange(SPAN, device=pos.device, dtype=torch.int32)
    in_range = iota[None, :] < (pos & (DEV_BLOCK - 1))[:, None]
    c6 = torch.arange(6, device=pos.device, dtype=torch.int32)
    eq = (sym[:, :, None] == c6[None, None, :]) & in_range[:, :, None]
    return occ[:, :6] + eq.sum(dim=1, dtype=torch.int32)


def extend_rank_step(index: DeviceFMDIndex, pos, sz, c_sel, do, pend,
                     p_rank):
    """One rank-side FMD extension step per lane (plain version of the
    per-step body of ``csrc/pingpong.cu``).

    pos' = C[c_sel] + rank_c(pos), sz' = rank_c(pos + sz) - rank_c(pos).
    Near lanes (off(pos) + sz <= 256) complete from the one row at pos.
    Wider lanes take two steps: step A reads the pos row, stashes
    rank_c(pos) in p_rank and raises pend; step B (the caller leaves the
    lane's state untouched in between) reads the row at pos + sz and
    completes. Returns (pos_n, sz_n, complete, pend_next, p_rank_next);
    lanes with complete=False must not apply pos/sz nor advance."""
    lo = torch.where(do, pos, 0)
    szm = torch.where(do, sz, 0)
    off_lo = lo & (DEV_BLOCK - 1)
    off_hi = off_lo + szm
    hi = lo + szm
    near = off_hi <= SPAN
    m_hi = torch.clamp(off_hi, max=SPAN)
    blk = torch.where(pend, hi >> LOG_BLOCK, lo >> LOG_BLOCK)
    # rank at lo normally, at hi when completing a two-step extension
    m_a = torch.where(pend, hi & (DEV_BLOCK - 1), off_lo)
    occ, sym = _unpack_rows(index.fused[blk.long()])
    iota = torch.arange(SPAN, device=pos.device, dtype=torch.int32)[None, :]
    eq = sym == c_sel[:, None]
    anchor = (occ.gather(1, c_sel[:, None].long())[:, 0]
              + (eq & (iota < m_a[:, None])).sum(dim=1, dtype=torch.int32))
    cnt = (eq & (iota >= off_lo[:, None]) & (iota < m_hi[:, None])).sum(
        dim=1, dtype=torch.int32)
    complete = pend | near
    pend_next = do & ~near & ~pend
    rank_lo = torch.where(pend, p_rank, anchor)
    sz_n = torch.where(pend, anchor - p_rank, cnt)
    pos_n = lookup_C(index, c_sel) + rank_lo
    return pos_n, sz_n, complete, pend_next, anchor
