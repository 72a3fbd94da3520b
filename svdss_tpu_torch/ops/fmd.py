"""FMD index on the device (PyTorch), narrow and wide mode.

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

Coordinate widths, two modes chosen by index size as the JAX package
chooses them:

  * **narrow** (n < 2^31): every count is a plain int32, as above.
  * **wide** (n >= 2^31, or ``force_wide``; up to 2^36 symbols, a whole
    two-strand human genome is ~6.2G): the checkpoint counts split into a
    low limb of ``limb_bits`` bits (31 by default) in the usual columns and
    a high limb of 5 bits a symbol packed into the spare columns 6 (occ)
    and 7 (order prefix), so rows keep their size and traffic. ``C`` then
    holds the full counts as int64. The plain versions and the kernel
    decode the limbs and compute in int64 coordinates; the limb width is a
    field of the table so that tests can shrink it and make the high limbs
    non-zero on a small genome.

An extension needs ranks at both interval endpoints (lo, hi = lo + sz);
because each row spans 256 symbols, both resolve from the one row at lo
whenever off(lo) + sz <= 256, and a wider extension takes a second step
that reads the row at hi (`extend_rank_step`).

The rank functions here are plain PyTorch versions. The search hot loop
runs `extend_rank_step` inside the CUDA kernel of ``csrc/pingpong.cu``;
these serve the CPU path, the tests, and the kernel's on-card check.

`build_jump_table` holds the bi-intervals of every ACGT k-mer (the k-mer
jump-start of the FM search, ``Config.kmer_jump``). On a CUDA table it
launches kernel K6 (``csrc/jump.cu``) once per level; on a CPU table it
runs `jump_level_plain`, which extends with the full bi-interval step
`extend_select` as the JAX package does. Both are narrow-only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..index.fmd import FMDIndex
from ..utils.device import (check_launch, load_kernels, resolve_device,
                            stream_handle)

launches = 0     # kernel K6 launches since the last reset

# order position of each symbol in the fmd cumulative assignment:
# $=0, T=1, G=2, C=3, A=4, N=5 (complement-sorted appended symbols)
_ORD_NP = np.array([0, 4, 3, 2, 1, 5], dtype=np.int32)

DEV_BLOCK = 128
SPAN = 2 * DEV_BLOCK
LOG_BLOCK = 7
OCC_COLS = 16
BWT_WORDS = SPAN // 8
ROW_WORDS = OCC_COLS + BWT_WORDS
LIMB_BITS = 31   # wide mode's default low-limb width


def fused_from_host(idx: FMDIndex, limb_bits: Optional[int] = None
                    ) -> np.ndarray:
    """The fused [nblk, 48] int32 table of an index, built in
    bounded-memory chunks: narrow, or wide with `limb_bits`-bit low limbs
    and 5-bit high limbs in columns 6 and 7."""
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
    if limb_bits is None:
        assert occ6.max() < 2**31
        out[:, :6] = occ6
        out[:, 8:14] = ord6_pre
        return out
    assert occ6.max() < 2**(limb_bits + 5), \
        "wide mode is limited to 5-bit high limbs"
    mask = (1 << limb_bits) - 1
    out[:, :6] = occ6 & mask
    out[:, 8:14] = ord6_pre & mask
    for c in range(6):
        out[:, 6] |= ((occ6[:, c] >> limb_bits) << (5 * c)).astype(np.int32)
        out[:, 7] |= ((ord6_pre[:, c] >> limb_bits) << (5 * c)).astype(
            np.int32)
    return out


class DeviceFMDIndex(NamedTuple):
    """FMD index resident in device memory. ``limb_bits is None`` is
    narrow mode (int32 counts and C); otherwise wide mode, with the low
    limbs `limb_bits` wide and C as int64 full counts."""
    fused: torch.Tensor      # [nblk, 48] int32
    C: torch.Tensor          # [8] cumulative counts: int32, int64 if wide
    limb_bits: Optional[int] = None

    @classmethod
    def from_host(cls, idx: FMDIndex, device=None, force_wide: bool = False,
                  limb_bits: int = LIMB_BITS) -> "DeviceFMDIndex":
        """The device table of a host index: wide when the index holds
        2^31 symbols or more, or when `force_wide` asks for it."""
        if idx.n >= 2**36:
            raise ValueError("one index is limited to 2^36 symbols")
        if not (force_wide or idx.n >= 2**31):
            return cls.from_arrays(fused_from_host(idx), idx.C, device)
        # the widest interval is one symbol's count; sizes stay below 2^32
        if int(np.diff(np.asarray(idx.C, dtype=np.int64)).max()) >= 2**32:
            raise ValueError("a symbol count past 2^32 does not fit wide mode")
        return cls.from_arrays(fused_from_host(idx, limb_bits), idx.C,
                               device, limb_bits=limb_bits)

    @classmethod
    def from_arrays(cls, fused: np.ndarray, C: np.ndarray, device=None,
                    C_hi: Optional[np.ndarray] = None,
                    limb_bits: Optional[int] = None) -> "DeviceFMDIndex":
        """Wrap an existing fused table and C (e.g. the JAX package's
        DeviceFMDIndex arrays, so both engines read one table). A wide
        table comes with `limb_bits`, or with the JAX package's split C:
        `C` the low limbs and `C_hi` the high limbs (limb width 31 unless
        `limb_bits` says otherwise)."""
        dev = resolve_device(device)
        fused = np.ascontiguousarray(fused, dtype=np.int32)
        if not fused.flags.writeable:       # e.g. a view of a JAX array
            fused = fused.copy()
        C = np.asarray(C, dtype=np.int64)
        if fused.ndim != 2 or fused.shape[1] != ROW_WORDS:
            raise ValueError(f"fused must be [nblk, {ROW_WORDS}]")
        if C_hi is not None:
            limb_bits = LIMB_BITS if limb_bits is None else limb_bits
            C = C + (np.asarray(C_hi, dtype=np.int64) << limb_bits)
        if C.shape != (8,):
            raise ValueError("C must hold 8 counts")
        if limb_bits is None:
            if C.max() >= 2**31:
                raise ValueError("C past 2^31 needs wide mode (limb_bits)")
            C = C.astype(np.int32)
        elif not 1 <= limb_bits <= 31:
            raise ValueError("limb_bits must be in [1, 31]")
        return cls(fused=torch.from_numpy(fused).to(dev),
                   C=torch.from_numpy(C).to(dev), limb_bits=limb_bits)

    @property
    def wide(self) -> bool:
        return self.limb_bits is not None

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


def _unpack_rows(index: DeviceFMDIndex, rows: torch.Tensor):
    """[R, 48] fused rows -> (occ [R, 6], sym [R, 256] int32): the occ
    checkpoints (int64 full counts in wide mode, the limbs joined) and
    column c of sym being span position c."""
    occ = rows[:, :6]
    if index.wide:
        hi = (rows[:, 6:7] >> (5 * torch.arange(
            6, device=rows.device, dtype=torch.int32))) & 31
        occ = occ.to(torch.int64) + (hi.to(torch.int64) << index.limb_bits)
    rep = rows[:, OCC_COLS:].repeat(1, 8)
    shifts = (torch.arange(SPAN, device=rows.device,
                           dtype=torch.int32) // BWT_WORDS) * 4
    return occ, (rep >> shifts) & 0xF


def rank6(index: DeviceFMDIndex, pos: torch.Tensor) -> torch.Tensor:
    """Counts of all 6 symbols in BWT[0:pos] for a batch of positions
    (pos [Q], 0 <= pos <= n; int64 past 2^31). Returns [Q, 6], int32 in
    narrow mode and int64 in wide mode."""
    occ, sym = _unpack_rows(index, index.fused[(pos >> LOG_BLOCK).long()])
    iota = torch.arange(SPAN, device=pos.device, dtype=torch.int32)
    in_range = iota[None, :] < (pos & (DEV_BLOCK - 1))[:, None]
    c6 = torch.arange(6, device=pos.device, dtype=torch.int32)
    eq = (sym[:, :, None] == c6[None, None, :]) & in_range[:, :, None]
    return occ + eq.sum(dim=1, dtype=occ.dtype)


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
    lanes with complete=False must not apply pos/sz nor advance.

    In wide mode pos, sz and p_rank are int64 and so are the results: the
    JAX package's limb pairs joined into one coordinate (its two-step
    extension and its near test are the same)."""
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
    occ, sym = _unpack_rows(index, index.fused[blk.long()])
    iota = torch.arange(SPAN, device=pos.device, dtype=torch.int32)[None, :]
    eq = sym == c_sel[:, None]
    anchor = (occ.gather(1, c_sel[:, None].long())[:, 0]
              + (eq & (iota < m_a[:, None])).sum(dim=1, dtype=occ.dtype))
    cnt = (eq & (iota >= off_lo[:, None]) & (iota < m_hi[:, None])).sum(
        dim=1, dtype=occ.dtype)
    complete = pend | near
    pend_next = do & ~near & ~pend
    rank_lo = torch.where(pend, p_rank, anchor)
    sz_n = torch.where(pend, anchor - p_rank, cnt)
    pos_n = lookup_C(index, c_sel) + rank_lo
    return pos_n, sz_n, complete, pend_next, anchor


# ---------------------------------------------------------------- jump table

def ord6(c: torch.Tensor) -> torch.Tensor:
    """Complement-order position of a symbol ($=0, T=1, G=2, C=3, A=4,
    N=5)."""
    return torch.where(c == 0, 0, torch.where(c == 5, 5, 5 - c))


def _gathered_rank(index: DeviceFMDIndex, pos, c_sel, o_sel):
    """Rank of c_sel and the count of symbols ordered before o_sel in
    BWT[0:pos), each from the row at pos: its checkpoint plus the span
    positions below pos & 127."""
    rows = index.fused[(pos >> LOG_BLOCK).long()]
    occ, sym = _unpack_rows(index, rows)
    iota = torch.arange(SPAN, device=pos.device, dtype=torch.int32)
    m = iota[None, :] < (pos & (DEV_BLOCK - 1))[:, None]
    rank = (((sym == c_sel[:, None]) & m).sum(dim=1, dtype=torch.int32)
            + occ.gather(1, c_sel[:, None].long())[:, 0])
    ordr = (((ord6(sym) < o_sel[:, None]) & m).sum(dim=1, dtype=torch.int32)
            + rows[:, 8:14].gather(1, o_sel[:, None].long())[:, 0])
    return rank, ordr


def extend_select(index: DeviceFMDIndex, x0, x1, sz, is_back, c_sel, do):
    """Extend each lane's bi-interval (x0, x1, sz) by its selected symbol:
    the fused `rb3_fmd_extend` for one child, with rank and complement-
    order counts read at both endpoints lo and hi = lo + sz.

    is_back True prepends c_sel (ranks at the x0 side); False is the
    forward child ok[c_sel] (ranks at the x1 side). Lanes with do False
    run a 0-width query at position 0; callers mask them. Narrow tables
    only, as in the JAX package."""
    if index.wide:
        raise ValueError("extend_select is narrow-only (jump tables)")
    lo = torch.where(do, torch.where(is_back, x0, x1), 0)
    hi = lo + torch.where(do, sz, 0)
    o_sel = ord6(c_sel)
    rank_lo, ord_lo = _gathered_rank(index, lo, c_sel, o_sel)
    rank_hi, ord_hi = _gathered_rank(index, hi, c_sel, o_sel)
    xr = lookup_C(index, c_sel) + rank_lo
    xo = torch.where(is_back, x1, x0) + (ord_hi - ord_lo)
    return (torch.where(is_back, xr, xo), torch.where(is_back, xo, xr),
            rank_hi - rank_lo)


def jump_level_plain(index: DeviceFMDIndex, parents: torch.Tensor,
                     chunk: int = 1 << 18) -> torch.Tensor:
    """Plain version of kernel K6: the [4n, 4] rows (x0, x1, sz, 0) of the
    backward extensions of n parent rows by A, C, G, T, child (c - 1) * n
    + p of parent p. A parent with sz 0 gives (C[c], its x1, 0, 0), as
    the JAX package's masked lanes do. Parents go `chunk` at a time, to
    bound the unpacked rows' memory."""
    n = parents.shape[0]
    out = torch.zeros((4 * n, 4), dtype=torch.int32, device=parents.device)
    for s0 in range(0, n, chunk):
        par = parents[s0:s0 + chunk]
        x0, x1, sz = par[:, 0], par[:, 1], par[:, 2]
        do = sz > 0
        back = torch.ones_like(do)
        for c in range(1, 5):
            cs = torch.full_like(x0, c)
            r0, r1, rs = extend_select(index, x0, x1, sz, back, cs, do)
            rows = out[(c - 1) * n + s0:(c - 1) * n + s0 + len(par)]
            rows[:, 0], rows[:, 1] = r0, r1
            rows[:, 2] = torch.where(do, rs, 0)
    return out


def level_one(index: DeviceFMDIndex) -> torch.Tensor:
    """The [4, 4] rows of the single symbols A..T: (C[c], C[comp c],
    C[c + 1] - C[c], 0)."""
    C = index.C
    c = torch.arange(1, 5, device=C.device)
    return torch.stack([C[c], C[5 - c], C[c + 1] - C[c],
                        torch.zeros_like(C[c])], dim=1).contiguous()


def build_jump_table(index: DeviceFMDIndex, k: int) -> torch.Tensor:
    """Bi-intervals of every ACGT k-mer, level by level: an int32 [4^k, 4]
    table of (x0, x1, sz, 0) rows on the index's device, keyed by
    sum (sym - 1) * 4^i with the last symbol at 4^0 (the child key of a
    prepended symbol c is (c - 1) * 4^j + the parent's). Absent k-mers have
    sz 0, with the columns the JAX package's `build_jump_table` gives them.
    A CUDA table launches kernel K6 k - 1 times; a CPU table runs the plain
    version."""
    if index.wide:
        raise ValueError("k-mer jump tables are narrow-only")
    if not 1 <= k <= 15:
        raise ValueError("jump table k must be in [1, 15]")
    if not index.fused.is_cuda:
        return build_jump_table_plain(index, k)
    rows = level_one(index)
    if k == 1:
        return rows
    # levels 1..k-2 alternate between two buffers; the last writes the
    # table itself
    table = torch.empty((4 ** k, 4), dtype=torch.int32, device=index.device)
    bufs = [torch.empty((4 ** (k - 1), 4), dtype=torch.int32,
                        device=index.device) for _ in range(min(2, k - 2))]
    for j in range(1, k):
        out = table if j == k - 1 else bufs[(j - 1) % 2][:4 ** (j + 1)]
        _launch_jump_level(index, rows, out)
        rows = out
    return table


def build_jump_table_plain(index: DeviceFMDIndex, k: int) -> torch.Tensor:
    """Plain version of `build_jump_table`: the level loop over
    `jump_level_plain`, on the table's device."""
    rows = level_one(index)
    for _ in range(1, k):
        rows = jump_level_plain(index, rows)
    return rows


def _launch_jump_level(index: DeviceFMDIndex, parents: torch.Tensor,
                       out: torch.Tensor) -> None:
    global launches
    n = parents.shape[0]
    if (index.fused.dtype != torch.int32 or index.fused.shape[1] != ROW_WORDS
            or not index.fused.is_contiguous() or index.C.dtype != torch.int32
            or parents.dtype != torch.int32 or parents.shape != (n, 4)
            or not parents.is_contiguous() or out.shape != (4 * n, 4)
            or not out.is_contiguous() or out.device != index.device
            or parents.device != index.device):
        raise TypeError("jump_level takes a narrow int32 table, int32 [n, 4] "
                        "parents and a [4n, 4] output on one device")
    rc = load_kernels()["jump"].svdss_jump_level(
        index.fused.data_ptr(), index.C.data_ptr(), parents.data_ptr(), n,
        out.data_ptr(), stream_handle(index.device))
    check_launch(rc, "jump_level")
    launches += 1
