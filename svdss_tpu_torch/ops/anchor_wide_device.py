"""Wide anchor-verify SFS search on the device: tables, one-shot batches
and parked-phase waves.

The device form of ops/anchor_wide.py (forward-strand tables, uint32
coordinates: the engine of genomes past int32, ~6.2G two-strand symbols
stored as ~3.1G forward ones). Each lane is one read and a restart-level
state machine like the narrow engine's (ops/anchor_device.py), with two
orientations per matching-statistics phase:

    KEY   read the k-mer at the cursor; its forward count and two-strand
          total come from one fused count word; chain orientation A's
          first verify (the text to the right of a forward occurrence)
    KEYB  start orientation B: occurrences of the reverse-complement
          k-mer, verified leftward against the other side of the read
    SUB   presence-bitmap cascade for an absent k-mer (m < k)
    POS   the next occurrence of a bucket: a binary probe on
          suffix-ordered buckets, else the next poslist pair
    VER   continue a verify past the end of a text row

A k-mer whose two-strand count passes cmax is heavy: the one-shot search
flags the read ``incomplete`` (the host redoes it); the wave driver parks
the lane instead (mode PARKED), answers the phase on the host from the
heavy store (`make_heavy_resolver`) and resumes the lane (mode RESOLVED)
in the next wave. A lane that parks more than `park_limit` times, a read
with a non-ACGT symbol and a verify that touches a text row with one go
to the host whole.

On a CUDA tensor a wave (or a one-shot batch) is one launch of kernel K5
(``csrc/anchor_wide.cu``), one thread per lane, run to completion or to a
park, reading its state from and writing it back to a device tensor; on a
CPU tensor it runs the plain version, the lockstep loop of the JAX
package's ``ops/anchor_wide_jax.py`` written out in tensor ops over all
lanes. Both give that module's six result fields exactly, including which
lanes are incomplete and the round count: those follow the JAX package's
layout (reads and text in 512-symbol span rows at stride 256, 2 bits a
symbol, emissions merged every 8 rounds from each wave's start), which the
kernel reproduces arithmetically.

Table layout (`build_device_anchor_wide`, the JAX package's arrays; the
uint32 ones held as int32 bit patterns, the plain version widening them
with ``& 0xFFFFFFFF``):

    ct        int32 fused counts: two keys a word of 8-bit forward count |
              8-bit two-strand total (cmax <= 254, both saturated at 255),
              else one key a word of 16 | 16 bits (saturated at 65,535)
    aux       [4^k] uint32: the position (count 1), the poslist offset, or
              0xFFFFFFFF (pruned heavy k-mer)
    pospairs  [NPp, 2] uint32 poslist, two entries a row
    bms       [B, 2] int32 two-strand presence bitmaps of levels j0 < j < k
    text2     [n//256 + 1, 32] int32: row m holds the 512 text symbols from
              256*m, 2 bits each (value nt6 - 1; 0 where non-ACGT)
    badrow    [ceil(nrow/32)] int32 bits: rows holding a non-ACGT symbol or
              reaching past the text
    lperm     packed uint8 (or uint16 when cmax > 254) left-order inverse
              permutation of each bucket; one dummy word on right-order-only
              and unsorted tables
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .anchor_wide import AnchorIndexWide
from .pingpong import PingPongResult
from ..utils.device import (check_launch, load_kernels, resolve_device,
                            stream_handle)

SPAN2 = 512       # symbols per span row
STRIDE2 = 256     # span stride in symbols
SPAN2_W = 32      # int32 words per span row (16 2-bit symbols each)
STAGE_EVERY = 8   # rounds between emission merges (the overflow check)
M32 = 0xFFFFFFFF

# lane modes (PARKED and RESOLVED only under the wave driver)
KEY, SUB, POS, VER, KEYB, PARKED, RESOLVED = range(7)

# per-lane state, one int32 row each of the [len(STATE), Q] state tensor
# that a launch reads at entry and writes back at exit (aux and occ_pos are
# uint32 bit patterns)
STATE = ("active", "fb", "dirb", "mode", "anc", "strand", "key", "keyb",
         "cntb", "subj", "cnt", "aux", "occ_i", "bhi", "llcp", "rlcp",
         "inj_m", "occ_pos", "ext", "best", "nsfs", "overflow")
S = {name: i for i, name in enumerate(STATE)}

# the `work` counters: lane rounds, table rows read (count, aux, poslist,
# bitmap and permutation words), text rows compared against, symbols
# compared
WORK_FIELDS = ("rounds", "table_rows", "text_rows", "symbols")

launches = 0     # kernel K5 launches since the last reset


class DeviceAnchorWide(NamedTuple):
    ct: torch.Tensor          # fused counts (see module docstring)
    aux: torch.Tensor         # [4^k] uint32 as int32
    pospairs: torch.Tensor    # [NPp, 2] uint32 as int32
    bms: torch.Tensor         # [B, 2] int32
    text2: torch.Tensor       # [nrow, 32] int32
    badrow: torch.Tensor      # [ceil(nrow/32)] int32
    lperm: torch.Tensor       # packed left-order permutation, int32 words

    @property
    def device(self) -> torch.device:
        return self.ct.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


@dataclasses.dataclass(frozen=True)
class WideParams:
    k: int
    j0: int
    cmax: int
    n: int
    bm_bases: Tuple[int, ...]     # row offset per level j0+1 .. k-1
    sorted_b: bool = False        # buckets suffix-ordered (binary probes)
    l16: bool = False             # lperm holds uint16 (cmax > 254)
    right_only: bool = False      # right order only: orientation A probes,
                                  # orientation B scans its bucket linearly
    ct16: bool = True             # counts 8|8 two keys a word, else 16|16


def pack_text2(text: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """nt6 uint8 [n] -> ([n//256 + 1, 32] int32 2-bit span rows, badrow
    bits as int32). Symbol value = nt6 - 1 for ACGT; any other symbol, and
    any position past the text, is 0 in the rows and flags every row that
    covers it."""
    n = len(text)
    nrow = n // STRIDE2 + 1
    sym = np.zeros((nrow + 1) * STRIDE2, dtype=np.uint8)
    sym[:n] = text
    bad_at = (sym < 1) | (sym > 4)
    bad_at[n:] = True
    two = np.where(bad_at, 0, sym.astype(np.int64) - 1).astype(np.uint32)
    spans = np.lib.stride_tricks.as_strided(
        two, shape=(nrow, SPAN2), strides=(two.strides[0] * STRIDE2,
                                           two.strides[0]))
    shifts = np.arange(16, dtype=np.uint32) * 2
    words = (spans.reshape(nrow, SPAN2_W, 16)
             << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
    badspan = np.lib.stride_tricks.as_strided(
        bad_at, shape=(nrow, SPAN2), strides=(bad_at.strides[0] * STRIDE2,
                                              bad_at.strides[0]))
    idx = np.nonzero(badspan.any(axis=1))[0]
    bw = np.zeros((nrow + 31) // 32, dtype=np.uint32)
    np.bitwise_or.at(bw, idx >> 5, np.uint32(1) << (idx & 31).astype(
        np.uint32))
    return words.view(np.int32), bw.view(np.int32)


def _as_i32(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a.astype(np.int32)


def build_device_anchor_wide(widx: AnchorIndexWide, device=None
                             ) -> Tuple[DeviceAnchorWide, WideParams]:
    """The device tables of host wide tables on `device` (cuda unless asked
    otherwise), with the JAX package's choices: the fused count format
    (8|8 when cmax <= 254, else 16|16), uint8 or uint16 lperm, sorted or
    right-order-only buckets."""
    dev = resolve_device(device)
    k, j0 = widx.k, widx.j0
    pl = widx.poslist
    if len(pl) == 0:
        pl = np.zeros(2, dtype=np.uint32)
    if len(pl) % 2:
        pl = np.concatenate([pl, np.zeros(1, dtype=pl.dtype)])
    bm_parts, bm_bases, row = [], [], 0
    for j in range(j0 + 1, k):
        bm = widx.levels[j]
        if len(bm) % 2:
            bm = np.concatenate([bm, np.zeros(1, dtype=bm.dtype)])
        bm_parts.append(_as_i32(bm).reshape(-1, 2))
        bm_bases.append(row)
        row += len(bm_parts[-1])
    bms = (np.concatenate(bm_parts) if bm_parts
           else np.zeros((1, 2), dtype=np.int32))
    text2, badrow = pack_text2(widx.text)
    sorted_b = widx.leftidx is not None or widx.right_sorted
    right_only = sorted_b and widx.leftidx is None
    l16 = widx.leftidx is not None and widx.leftidx.dtype == np.uint16
    lperm = np.zeros(1, dtype=np.int32)
    if widx.leftidx is not None and len(widx.leftidx):
        li = widx.leftidx
        pad = (-len(li)) % (2 if l16 else 4)
        if pad:
            li = np.concatenate([li, np.zeros(pad, dtype=li.dtype)])
        lperm = np.ascontiguousarray(li).view(np.int32)
    # fused count table: forward count | two-strand total per key
    # (saturated), so the KEY round reads one word for both; computed on
    # `dev` from the uploaded counts (at k = 14, 4^14 keys)
    nk = 1 << (2 * k)
    cf = torch.from_numpy(widx.cnts.astype(np.int32)).to(dev).long()
    tot = cf + cf[_rc_key(torch.arange(nk, device=dev), k)]
    ct16 = widx.cmax <= 254
    if ct16:
        ctw = cf.clamp(max=255) | (tot.clamp(max=255) << 8)
        ct = _to_i32(ctw[0::2] | (ctw[1::2] << 16))
        del ctw
    else:
        ct = _to_i32(cf.clamp(max=65535) | (tot.clamp(max=65535) << 16))
    del cf, tot

    def put(a):
        a = _as_i32(a)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)
    index = DeviceAnchorWide(
        ct=ct, aux=put(widx.aux.astype(np.uint32)),
        pospairs=put(pl.astype(np.uint32).reshape(-1, 2)), bms=put(bms),
        text2=put(text2), badrow=put(badrow), lperm=put(lperm))
    params = WideParams(k=k, j0=j0, cmax=int(widx.cmax), n=widx.n,
                        bm_bases=tuple(bm_bases), sorted_b=sorted_b,
                        l16=l16, right_only=right_only, ct16=ct16)
    return index, params


def words_per_lane2(lp1: int) -> int:
    """2-bit read words per side in the JAX layout: the read padded to a
    multiple of 256 symbols plus one 256-symbol row of slack, doubled."""
    return 32 * ((lp1 + 255) // 256 + 1)


def default_max_rounds(lp1: int) -> int:
    return 8 * (lp1 - 1) + 64


def has_bad_symbols(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[Q] bool: reads holding a symbol other than ACGT (they go to the
    host from the start)."""
    pos = torch.arange(seqs.shape[1], device=seqs.device)
    inread = pos[None, :] < lens[:, None]
    return (inread & ((seqs < 1) | (seqs > 4))).any(dim=1)


def reset_state(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The [len(STATE), Q] int32 state of fresh lanes: running (unless the
    read is empty or holds a non-ACGT symbol), backward phase at the last
    symbol, mode KEY."""
    Q = lens.shape[0]
    st = torch.zeros((len(STATE), Q), dtype=torch.int32, device=lens.device)
    st[S["active"]] = (lens >= 1).to(torch.int32)
    st[S["fb"]] = has_bad_symbols(seqs, lens).to(torch.int32)
    st[S["dirb"]] = 1
    st[S["mode"]] = KEY
    st[S["anc"]] = lens - 1
    return st


def result_of(state: torch.Tensor, out_qs: torch.Tensor,
              out_l: torch.Tensor, rounds: torch.Tensor) -> PingPongResult:
    """The six result fields of lanes whose state, emissions and round
    count a wave (or a one-shot batch) left."""
    return PingPongResult(
        qs=out_qs, length=out_l, n_sfs=state[S["nsfs"]].clone(),
        overflow=state[S["overflow"]] != 0,
        incomplete=(state[S["fb"]] != 0) | (state[S["active"]] != 0),
        iters=rounds.reshape(()).clone())


def _check(index: DeviceAnchorWide, params: WideParams, seqs: torch.Tensor,
           lens: torch.Tensor, cap: int, work: Optional[torch.Tensor]):
    Q, Lp1 = seqs.shape
    if seqs.dtype != torch.uint8 or lens.dtype != torch.int32 \
            or lens.shape != (Q,):
        raise TypeError("seqs must be uint8 [Q, L+1] and lens int32 [Q]")
    if work is not None and (work.dtype != torch.int64
                             or work.shape != (len(WORK_FIELDS),)):
        raise TypeError("work must be int64 [4]")
    devs = {t.device for t in (seqs, lens, work, *index) if t is not None}
    if len(devs) != 1:
        raise ValueError("index, seqs, lens and work must share one device")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in index):
        raise TypeError("the wide tables must be contiguous int32 tensors")
    if index.text2.shape != (params.n // STRIDE2 + 1, SPAN2_W):
        raise ValueError("text2 does not match params.n")
    if not 1 <= params.k <= 15:
        raise ValueError("anchor k must be in [1, 15]")
    if cap < 1:
        raise ValueError("cap must be >= 1")


# -------------------------------------------------------------- one wave

def run_wave(index: DeviceAnchorWide, params: WideParams,
             seqs: torch.Tensor, lens: torch.Tensor, state: torch.Tensor,
             out_qs: torch.Tensor, out_l: torch.Tensor,
             rounds: torch.Tensor, r0: int, cap: int, max_rounds: int,
             overlap: int, park: bool, work: Optional[torch.Tensor] = None,
             chunks: Optional[torch.Tensor] = None) -> None:
    """Run every runnable lane from round `r0` until it ends, parks (with
    `park`) or reaches `max_rounds`; `state`, `out_qs`, `out_l` are updated
    in place and `rounds` ([1] int32) ends as the round at which the last
    lane stopped (at least r0). On a CUDA tensor this is one launch of K5;
    on a CPU tensor the plain version (`chunks`: the read rows of
    `read_chunks`, built once per batch)."""
    if seqs.is_cuda:
        _launch(index, params, seqs, lens, state, out_qs, out_l, rounds, r0,
                cap, max_rounds, overlap, park, work)
    else:
        if chunks is None:
            chunks = read_chunks(seqs, lens)
        run_wave_plain(index, params, chunks, lens, state, out_qs, out_l,
                       rounds, r0, cap, max_rounds, overlap, park, work)


def _launch(index, params, seqs, lens, state, out_qs, out_l, rounds, r0,
            cap, max_rounds, overlap, park, work) -> None:
    global launches
    Q, Lp1 = seqs.shape
    dev = seqs.device
    lib = load_kernels()["anchor_wide"]
    tables = np.array([t.data_ptr() for t in index], dtype=np.uint64)
    dims = np.zeros(32, dtype=np.int64)
    dims[:7] = [t.shape[0] for t in index]
    dims[7:14] = [params.k, params.j0, params.cmax, params.sorted_b,
                  params.l16, params.right_only, params.ct16]
    dims[14 + params.j0 + 1:14 + params.k] = params.bm_bases
    rounds.fill_(r0)
    rc = lib.svdss_anchor_wide(
        tables.ctypes.data, dims.ctypes.data, seqs.data_ptr(),
        lens.data_ptr(), Q, Lp1, cap, max_rounds, overlap, int(park), r0,
        state.data_ptr(), out_qs.data_ptr(), out_l.data_ptr(),
        rounds.data_ptr(), work.data_ptr() if work is not None else None,
        stream_handle(dev))
    check_launch(rc, "anchor_wide")
    launches += 1


# ------------------------------------------------------------ entry points

def batch_search_anchor_wide(index: DeviceAnchorWide, params: WideParams,
                             seqs: torch.Tensor, lens: torch.Tensor,
                             cap: int = 128, max_rounds: int = 0,
                             overlap: int = -1,
                             work: Optional[torch.Tensor] = None
                             ) -> PingPongResult:
    """Wide anchor-verify ping-pong over a padded read batch, one shot:
    lanes that land on a heavy k-mer come back incomplete.

    seqs: [Q, L+1] uint8 nt6, 0-padded; lens: [Q] int32. max_rounds=0
    means 8*L + 64. work: optional int64 [4] tensor to which the
    `WORK_FIELDS` counts are added (a measurement aid)."""
    _check(index, params, seqs, lens, cap, work)
    Q, Lp1 = seqs.shape
    seqs, lens = seqs.contiguous(), lens.contiguous()
    state = reset_state(seqs, lens)
    out_qs = torch.zeros((Q, cap), dtype=torch.int32, device=seqs.device)
    out_l = torch.zeros_like(out_qs)
    rounds = torch.zeros(1, dtype=torch.int32, device=seqs.device)
    run_wave(index, params, seqs, lens, state, out_qs, out_l, rounds, 0,
             cap, max_rounds or default_max_rounds(Lp1), overlap, False,
             work)
    return result_of(state, out_qs, out_l, rounds)


Resolver = Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]


class WideWaveRun:
    """An in-flight parked-phase wide search. Construction resets the lanes
    and launches the first wave (a CUDA launch returns once queued, so the
    caller can pack the next batch meanwhile); `service()` advances one
    wave: it pulls one snapshot of (mode, anc, dirb, fb, active, rounds) to
    the host, answers every parked phase with ``resolve_phases(lanes,
    ancs, dirbs) -> m`` (int32), pushes mode / inj_m / fb back and
    relaunches; `finish()` runs waves to the end. Lane state stays on the
    device between waves.

    `rounds` counts across waves: a lane that resumes in wave w starts at
    the total of waves 1..w-1, max_rounds bounds that total (parked lanes
    still waiting when it is spent go to the host), and the result's
    iters is the final total."""

    def __init__(self, index: DeviceAnchorWide, params: WideParams,
                 seqs: torch.Tensor, lens: torch.Tensor,
                 resolve_phases: Resolver, cap: int = 128,
                 max_rounds: int = 0, overlap: int = -1,
                 park_limit: int = 16, work: Optional[torch.Tensor] = None):
        _check(index, params, seqs, lens, cap, work)
        Q, Lp1 = seqs.shape
        self.index, self.params = index, params
        self.seqs, self.lens = seqs.contiguous(), lens.contiguous()
        self.resolve_phases = resolve_phases
        self.cap, self.overlap, self.park_limit = cap, overlap, park_limit
        self.max_rounds = max_rounds or default_max_rounds(Lp1)
        self.work = work
        self.parks = np.zeros(Q, dtype=np.int64)
        self.n_waves = 0        # waves that resolved at least one phase
        self.parked_lanes = 0   # phases answered on the host
        self._done = False
        dev = seqs.device
        # the plain version reads the rows of the JAX layout: pack once
        self.chunks = None if seqs.is_cuda else read_chunks(self.seqs,
                                                            self.lens)
        self.state = reset_state(self.seqs, self.lens)
        self.out_qs = torch.zeros((Q, cap), dtype=torch.int32, device=dev)
        self.out_l = torch.zeros_like(self.out_qs)
        self.rounds = torch.zeros(1, dtype=torch.int32, device=dev)
        self._wave(0)

    def _wave(self, r0: int) -> None:
        run_wave(self.index, self.params, self.seqs, self.lens, self.state,
                 self.out_qs, self.out_l, self.rounds, r0, self.cap,
                 self.max_rounds, self.overlap, True, self.work, self.chunks)

    def service(self) -> bool:
        """Advance by one wave; returns False once the run is complete."""
        if self._done:
            return False
        rows = [S["mode"], S["anc"], S["dirb"], S["fb"], S["active"]]
        snap = torch.cat([self.state[rows].reshape(-1),
                          self.rounds]).cpu().numpy()
        Q = self.state.shape[1]
        mode, anc, dirb, fbv, act = snap[:-1].reshape(5, Q)
        rounds = int(snap[-1])
        lanes = np.flatnonzero((act != 0) & (fbv == 0) & (mode == PARKED))
        if lanes.size == 0:
            self._done = True
            return False
        fbv = fbv.copy()
        if rounds >= self.max_rounds:
            # the round budget is spent with phases still parked: those
            # lanes are redone on the host
            fbv[lanes] = 1
            self.state[S["fb"]] = torch.from_numpy(fbv).to(self.state.device)
            self._done = True
            return False
        self.parks[lanes] += 1
        over = self.parks[lanes] > self.park_limit
        good = lanes[~over]
        mode = mode.copy()
        inj = np.zeros(Q, dtype=np.int32)
        if good.size:
            self.n_waves += 1
            self.parked_lanes += int(good.size)
            inj[good] = self.resolve_phases(good, anc[good], dirb[good])
            mode[good] = RESOLVED
        fbv[lanes[over]] = 1
        push = torch.from_numpy(np.stack([mode, inj, fbv]).astype(np.int32))
        self.state[[S["mode"], S["inj_m"], S["fb"]]] = push.to(
            self.state.device, non_blocking=False)
        self._wave(rounds)
        return True

    def result(self) -> PingPongResult:
        """Final results; valid once service() has returned False."""
        return result_of(self.state, self.out_qs, self.out_l, self.rounds)

    def finish(self) -> PingPongResult:
        while self.service():
            pass
        return self.result()


class WideWaveScheduler:
    """Round-robin driver for several in-flight WideWaveRuns: while one
    run's wave runs on the card, the host resolves another's parked
    phases."""

    def __init__(self, runs):
        self.runs = list(runs)

    def finish_all(self) -> List[PingPongResult]:
        live = list(self.runs)
        while live:
            live = [r for r in live if r.service()]
        return [r.result() for r in self.runs]


def batch_search_anchor_wide_waves(index: DeviceAnchorWide,
                                   params: WideParams, seqs: torch.Tensor,
                                   lens: torch.Tensor,
                                   resolve_phases: Resolver, cap: int = 128,
                                   max_rounds: int = 0, overlap: int = -1,
                                   park_limit: int = 16,
                                   work: Optional[torch.Tensor] = None
                                   ) -> PingPongResult:
    """Wide anchor search with per-phase host resolve: heavy anchors park
    their lane, the host answers each parked phase exactly between waves
    and the lane resumes; a lane parking more than park_limit times goes
    to the host whole."""
    return WideWaveRun(index, params, seqs, lens, resolve_phases, cap=cap,
                       max_rounds=max_rounds, overlap=overlap,
                       park_limit=park_limit, work=work).finish()


# --------------------------------------------------------- plain version

def pack_read_words2(seqs: torch.Tensor, lens: torch.Tensor, wlp: int
                     ) -> torch.Tensor:
    """[Q, Lp1] uint8 nt6 + lens -> [Q, 2, wlp] int64 2-bit words (16
    symbols a word, as uint32 values). Side 0 is the read, side 1 the
    complement of the read zero-padded to 16*wlp symbols and reversed, so
    logical reverse-complement position x sits at x + 16*wlp - len; symbol
    value = nt6 - 1."""
    Q, Lp1 = seqs.shape
    s = seqs.to(torch.int64)
    pos = torch.arange(Lp1, device=seqs.device)
    v = torch.where(pos[None, :] < lens[:, None], (s - 1).clamp(0, 3), 0)
    vp = torch.zeros((Q, wlp * 16), dtype=torch.int64, device=seqs.device)
    vp[:, :Lp1] = v
    sh = torch.arange(16, device=seqs.device, dtype=torch.int64) * 2

    def pack(x):
        return (x.reshape(Q, wlp, 16) << sh).sum(dim=2)
    return torch.stack([pack(vp), pack(3 - vp.flip(1))], dim=1)


def derive_chunks2(words: torch.Tensor) -> torch.Tensor:
    """[Q, 2, wlp] words -> [Q, 2, nwm, 32] span rows: row m holds words
    [16m, 16m + 32) = symbols [256m, 256m + 512)."""
    Q, two, wlp = words.shape
    w16 = words.reshape(Q, two, wlp // 16, 16)
    return torch.cat([w16[:, :, :-1, :], w16[:, :, 1:, :]], dim=3)


def read_chunks(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    return derive_chunks2(pack_read_words2(
        seqs, lens, words_per_lane2(seqs.shape[1])))


def _unpack2(words: torch.Tensor) -> torch.Tensor:
    """[Q, 32] 2-bit words (any int dtype) -> [Q, 512] int64 symbols."""
    sh = torch.arange(16, device=words.device, dtype=torch.int64) * 2
    w = words.to(torch.int64) & M32
    return ((w[:, :, None] >> sh) & 3).reshape(words.shape[0], SPAN2)


def _rc_key(key: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-complement base-4 keys (int64 holding uint32 values): 2-bit
    digit reversal and per-digit complement."""
    y = key & M32
    y = ((y & 0x33333333) << 2) | ((y >> 2) & 0x33333333)
    y = ((y & 0x0F0F0F0F) << 4) | ((y >> 4) & 0x0F0F0F0F)
    y = ((y & 0x00FF00FF) << 8) | ((y >> 8) & 0x00FF00FF)
    y = ((y << 16) | (y >> 16)) & M32
    return (y >> (32 - 2 * k)) ^ ((1 << (2 * k)) - 1)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> the int32 of that pattern."""
    x = x & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def run_wave_plain(index: DeviceAnchorWide, params: WideParams,
                   chunks: torch.Tensor, lens: torch.Tensor,
                   state: torch.Tensor, out_qs: torch.Tensor,
                   out_l: torch.Tensor, rounds: torch.Tensor, r0: int,
                   cap: int, max_rounds: int, overlap: int, park: bool,
                   work: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of kernel K5: the JAX package's round body
    (anchor_wide_jax._make_round_body_wide), emission merge
    (_merge_stage_wide) and while-loops, written out over [Q] int64
    tensors on its span-row layout. All lanes advance in lockstep;
    emissions are staged and merged every 8 rounds from `r0`, when
    overflowed lanes stop. A round updates the lane tensors in place, so
    on a CUDA tensor the rounds after the first replay one captured CUDA
    graph of the round's ops."""
    dev = lens.device
    Q = lens.shape[0]
    k, j0, cmax = params.k, params.j0, params.cmax
    sorted_b, ronly = params.sorted_b, params.right_only
    nwm = chunks.shape[2]
    merged_rows = chunks.reshape(Q, 2 * nwm, SPAN2_W)
    lens = lens.to(torch.int64)
    lane = torch.arange(Q, device=dev)
    cc = torch.arange(SPAN2, device=dev, dtype=torch.int64)[None, :]
    st_iota = torch.arange(STAGE_EVERY, device=dev)
    ct = index.ct.to(torch.int64) & M32
    aux_t = index.aux.to(torch.int64) & M32
    pp = index.pospairs.to(torch.int64) & M32
    bms = index.bms.to(torch.int64) & M32
    badrow = index.badrow.to(torch.int64) & M32
    lperm = index.lperm.to(torch.int64) & M32
    nrow = index.text2.shape[0]
    npp = pp.shape[0]
    bm_bases = torch.tensor(
        ((0,) * (j0 + 1) + params.bm_bases + (0,))[:k], device=dev,
        dtype=torch.int64)
    s = {name: state[i].to(torch.int64) for i, name in enumerate(STATE)}
    s["aux"] &= M32
    s["occ_pos"] &= M32
    for f in ("active", "fb", "overflow"):
        s[f] = s[f] != 0
    # one spare column takes the merge writes that fall past cap
    oq = torch.cat([out_qs.to(torch.int64),
                    torch.zeros((Q, 1), dtype=torch.int64, device=dev)], 1)
    ol = torch.cat([out_l.to(torch.int64),
                    torch.zeros((Q, 1), dtype=torch.int64, device=dev)], 1)
    nstage = torch.zeros(Q, dtype=torch.int64, device=dev)
    stage_qs = torch.zeros((Q, STAGE_EVERY), dtype=torch.int64, device=dev)
    stage_l = torch.zeros_like(stage_qs)
    zero = torch.zeros(Q, dtype=torch.bool, device=dev)

    def update(**new):
        """Write a round's new lane values into the lane tensors (all new
        values are computed from the old ones first)."""
        for name, v in new.items():
            s[name].copy_(v)

    def runnable():
        r = s["active"] & ~s["fb"]
        return r & (s["mode"] != PARKED) if park else r

    def sym_at(rows_sym, off):
        ok = (off >= 0) & (off < SPAN2)
        got = rows_sym.gather(1, off.clamp(0, SPAN2 - 1)[:, None])[:, 0]
        return torch.where(ok, got, 0)

    def round_body():
        active = s["active"] & ~s["fb"] & (nstage < STAGE_EVERY)
        if park:
            active = active & (s["mode"] != PARKED)
        dirb, mode, anc, strand = s["dirb"], s["mode"], s["anc"], s["strand"]
        is_b = dirb == 1
        u = torch.where(is_b, lens - 1 - anc, anc)
        maxlen = torch.where(is_b, anc + 1, lens - anc)
        is_key = active & (mode == KEY)
        is_keyb = active & (mode == KEYB)
        is_sub = active & (mode == SUB)
        is_pos = active & (mode == POS)
        is_ver = active & (mode == VER)
        is_res = active & (mode == RESOLVED) if park else zero
        on_b = (strand == 1) & ~is_key        # orientation B (left compare)

        # the read row: right compares read side dirb forward; left
        # compares the other side backward from the mirror cursor; a
        # re-probe of a sorted bucket starts at min(llcp, rlcp)
        if sorted_b:
            probe_pos = is_pos & (strand != 1) if ronly else is_pos
        else:
            probe_pos = zero
        ext_floor = torch.minimum(s["llcp"], s["rlcp"])
        ext_eff = torch.where(is_ver, s["ext"],
                              torch.where(probe_pos, ext_floor, 0))
        r_right = torch.where(is_key, u, u + k + ext_eff)
        v_left = lens - 1 - (u + k + ext_eff)
        use_left = on_b & (is_keyb | is_pos | is_ver)
        rstart = torch.where(use_left, v_left, r_right)
        side = torch.where(use_left, 1 - dirb, dirb)
        rstart = rstart + torch.where(side == 1,
                                      (nwm + 1) * STRIDE2 - lens, 0)
        m_r = torch.where(use_left, ((rstart >> 8) - 1).clamp(0, nwm - 1),
                          (rstart >> 8).clamp(0, nwm - 1))
        chunk = _unpack2(merged_rows[lane, side * nwm + m_r])
        col_a = rstart - (m_r << 8)

        # KEY: both orientation keys from the row
        key = torch.zeros(Q, dtype=torch.int64, device=dev)
        for i in range(k):
            key = key | (sym_at(chunk, col_a + i) << (2 * (k - 1 - i)))
        keyb_new = _rc_key(key, k)
        floor_case = is_key & (maxlen <= j0)
        use_meta = is_key & (maxlen >= k)
        to_sub_short = is_key & (maxlen > j0) & (maxlen < k)

        # the fused count word: forward count and two-strand total
        if params.ct16:
            ctw = ct[torch.where(use_meta, key >> 1, 0)]
            ctv = (ctw >> ((key & 1) * 16)) & 0xFFFF
            cnt_a = ctv & 0xFF
            ctot = (ctv >> 8) & 0xFF
        else:
            ctw = ct[torch.where(use_meta, key, 0)]
            cnt_a = ctw & 0xFFFF
            ctot = (ctw >> 16) & 0xFFFF
        cnt_b = ctot - cnt_a
        k_heavy = use_meta & (ctot > cmax)
        k_empty = use_meta & (ctot == 0)
        fb_new = zero if park else k_heavy

        aux_row = torch.where(is_key, key, torch.where(is_keyb, s["keyb"], 0))
        aux_g = aux_t[aux_row.clamp(0, aux_t.shape[0] - 1)]
        start_a = use_meta & ~k_heavy & ~k_empty & (cnt_a >= 1)
        skip_to_b = use_meta & ~k_heavy & ~k_empty & (cnt_a == 0)
        a_single = start_a & (cnt_a == 1)
        a_multi = start_a & (cnt_a >= 2)
        b_single = is_keyb & (s["cntb"] == 1)
        b_multi = is_keyb & (s["cntb"] >= 2)
        chain_multi = a_multi | b_multi
        n_lperm = zero

        def pair_at(slot):
            row = pp[(slot >> 1).clamp(0, npp - 1)]
            return torch.where((slot & 1) == 1, row[:, 1], row[:, 0])

        if sorted_b:
            # binary probes: a bucket start probes its middle entry, a POS
            # round mid = (lo + hi) / 2; right compares index the bucket
            # directly, left compares through lperm (right-order-only
            # tables scan orientation B linearly)
            lo_eff = torch.where(is_key | is_keyb, 0, s["occ_i"])
            bhi_eff = torch.where(start_a, cnt_a,
                                  torch.where(is_keyb, s["cntb"], s["bhi"]))
            mid_eff = (lo_eff + bhi_eff) >> 1
            aux_for = torch.where(is_key | is_keyb, aux_g, s["aux"])
            if ronly:
                is_linb = on_b | is_keyb
                sel = torch.where(is_linb, lo_eff, mid_eff)
            else:
                is_linb = zero
                need_l = b_multi | (is_pos & (strand == 1))
                n_lperm = need_l
                lslot = (aux_for + mid_eff) & M32
                if params.l16:
                    lrow = (lslot >> 1).clamp(0, lperm.shape[0] - 1)
                    lw = lperm[torch.where(need_l, lrow, 0)]
                    li = (lw >> ((lslot & 1) * 16)) & 0xFFFF
                else:
                    lrow = (lslot >> 2).clamp(0, lperm.shape[0] - 1)
                    lw = lperm[torch.where(need_l, lrow, 0)]
                    li = (lw >> ((lslot & 3) * 8)) & 255
                sel = torch.where(need_l, li, mid_eff)
            slot = (aux_for + sel) & M32
            want_probe = a_multi | b_multi | is_pos
            occ_probe = pair_at(torch.where(want_probe, slot, 0))
            chained = a_single | a_multi | b_single | b_multi | is_pos
            ver_like = is_ver | chained
            occ_eff = torch.where(a_single | b_single, aux_g,
                                  torch.where(want_probe, occ_probe,
                                              s["occ_pos"]))
            occ_i_eff = lo_eff
            n_pairs = want_probe
        else:
            occ0 = pair_at(torch.where(chain_multi, aux_g, 0))
            pos_slot = (s["aux"] + s["occ_i"]) & M32
            occ_from_row = pair_at(torch.where(is_pos, pos_slot, 0))
            chained = a_single | a_multi | b_single | b_multi | is_pos
            ver_like = is_ver | chained
            occ_eff = torch.where(
                a_single | b_single, aux_g,
                torch.where(chain_multi, occ0,
                            torch.where(is_pos, occ_from_row,
                                        s["occ_pos"])))
            occ_i_eff = torch.where(is_key | is_keyb, 0, s["occ_i"])
            n_pairs = chain_multi | is_pos
        cnt_eff = torch.where(start_a, cnt_a,
                              torch.where(is_keyb, s["cntb"], s["cnt"]))
        best_eff = torch.where(is_key, 0, s["best"])
        aux_eff = torch.where(is_key | is_keyb, aux_g, s["aux"])
        on_b_eff = on_b | is_keyb
        left_cmp = ver_like & on_b_eff
        cmp_off = torch.where(is_key, col_a + k, col_a)

        # pair verify: screening rounds (ext == 0) verify two candidates
        # against the same read span (linear scans only)
        if sorted_b and not ronly:
            j2 = occ_i_eff
            pair_ok = zero
            occ_2nd = torch.zeros_like(occ_eff)
        else:
            j2 = occ_i_eff + 1
            pair_ok = ver_like & (ext_eff == 0) & (j2 < cnt_eff) \
                & ~(a_single | b_single)
            if ronly:
                pair_ok = pair_ok & is_linb
            occ_2nd = pair_at(torch.where(pair_ok, (aux_eff + j2) & M32, 0))
        vcap = maxlen - k

        def compare(occ_u, ext0, gate):
            """One text-row compare of the read row against occurrence
            occ_u at extension ext0: (ext_after, survive, row_bad, lt, D,
            first) — lt orders the text run below the query at the first
            mismatch (or exhausted at the text start)."""
            t_right = (occ_u + k + ext0) & M32
            avail_l = (occ_u - ext0) & M32
            tstart = torch.where(left_cmp, (avail_l - 1) & M32, t_right)
            tr_r = tstart >> 8
            tr = torch.where(left_cmp, (tr_r - 1).clamp(min=0), tr_r)
            tr = tr.clamp(0, nrow - 1)
            trow = _unpack2(index.text2[torch.where(gate, tr, 0)])
            col_t = _to_i32(tstart - (tr << 8)).to(torch.int64)
            badw = badrow[(tr >> 5).clamp(0, badrow.shape[0] - 1)]
            row_bad = gate & (((badw >> (tr & 31)) & 1) == 1)
            src = cc + (col_t - cmp_off)[:, None]
            shifted = torch.where((src >= 0) & (src < SPAN2),
                                  trow.gather(1, src.clamp(0, SPAN2 - 1)),
                                  0)
            dist = torch.where(left_cmp[:, None], cmp_off[:, None] - cc,
                               cc - cmp_off[:, None])
            mism = (shifted != chunk) & (dist >= 0)
            found = mism.any(dim=1)
            first_raw = torch.where(mism, dist, SPAN2).amin(dim=1)
            # the first mismatch's position, as the word-level scan leaves
            # it when there is none (one word past either end)
            pos = torch.where(found, torch.where(left_cmp,
                                                 cmp_off - first_raw,
                                                 cmp_off + first_raw),
                              torch.where(left_cmp, -17, 528))
            avail32 = torch.clamp(avail_l, max=1 << 20)
            first = torch.where(left_cmp, torch.minimum(first_raw, avail32),
                                first_raw)
            run_valid = torch.where(left_cmp,
                                    torch.minimum(cmp_off, col_t) + 1,
                                    SPAN2 - torch.maximum(cmp_off, col_t))
            run_cap = vcap - ext0
            run = torch.minimum(torch.minimum(first, run_valid), run_cap)
            ext_after = ext0 + run.clamp(min=0)
            hit_start = left_cmp & (first >= avail32)
            survive = gate & (first >= run_valid) & (ext_after < vcap) \
                & ~hit_start
            mpos = pos.clamp(0, SPAN2 - 1)[:, None]
            lt = hit_start | (shifted.gather(1, mpos)[:, 0]
                              < chunk.gather(1, mpos)[:, 0])
            D = torch.minimum(run_valid, run_cap)
            D = torch.where(left_cmp, torch.minimum(D, avail32), D)
            nsym = torch.where(gate & (D > 0),
                               torch.where(first_raw < D, first_raw + 1, D),
                               0)
            return ext_after, survive, row_bad, lt, nsym

        ext1_new, survive1, bad1, lt1, nsym1 = compare(occ_eff, ext_eff,
                                                       ver_like)
        if sorted_b and not ronly:
            ext2_new = torch.zeros_like(ext1_new)
            survive2 = bad2 = zero
            nsym2 = torch.zeros_like(nsym1)
        else:
            ext2_new, survive2, bad2, _, nsym2 = compare(
                occ_2nd, torch.zeros_like(ext_eff), pair_ok)
        fb_new = fb_new | bad1 | bad2

        best_new = torch.where(ver_like & ~survive1,
                               torch.maximum(best_eff, ext1_new), best_eff)
        llcp2, rlcp2, bhi2 = s["llcp"], s["rlcp"], s["bhi"]
        if sorted_b:
            # a finished probe moves the bracket [lo, hi) by its order bit;
            # its mismatch offset is the new fence LCP on that side
            if ronly:
                best_new = torch.where(pair_ok & ~survive2,
                                       torch.maximum(best_new, ext2_new),
                                       best_new)
            early = best_new >= vcap
            done1 = ver_like & ~survive1
            lo2 = torch.where(done1 & lt1, mid_eff + 1, lo_eff)
            hi2 = torch.where(done1 & ~lt1, mid_eff, bhi_eff)
            probe_ctx = ver_like & ~is_linb if ronly else ver_like
            llcp_eff = torch.where(is_key | is_keyb, 0, s["llcp"])
            rlcp_eff = torch.where(is_key | is_keyb, 0, s["rlcp"])
            llcp2 = torch.where(done1 & probe_ctx & lt1, ext1_new, llcp_eff)
            rlcp2 = torch.where(done1 & probe_ctx & ~lt1, ext1_new, rlcp_eff)
            if ronly:
                cont_a = ver_like & ~is_linb & ~early & survive1
                cont_b = ver_like & is_linb & ~early \
                    & (survive1 | (pair_ok & survive2))
                cont_occ = cont_a | cont_b
                cont_from2 = is_linb & ~survive1 & pair_ok & survive2
                occ_done = ver_like & ~cont_occ
                next_i = occ_i_eff + torch.where(pair_ok, 2, 1)
                more_occ = (occ_done & ~is_linb & (lo2 < hi2) & ~early) \
                    | (occ_done & is_linb & (next_i < cnt_eff) & ~early)
                occ_i2 = torch.where(
                    ver_like & is_linb,
                    torch.where(occ_done & (next_i < cnt_eff) & ~early,
                                next_i,
                                torch.where(cont_from2, j2, occ_i_eff)),
                    torch.where(ver_like, lo2, occ_i_eff))
                bhi2 = torch.where(ver_like & ~is_linb, hi2, bhi_eff)
            else:
                cont_occ = ver_like & ~early & survive1
                cont_from2 = zero
                occ_done = ver_like & ~cont_occ
                more_occ = occ_done & (lo2 < hi2) & ~early
                occ_i2 = torch.where(ver_like, lo2, occ_i_eff)
                bhi2 = torch.where(ver_like, hi2, bhi_eff)
        else:
            best_new = torch.where(pair_ok & ~survive2,
                                   torch.maximum(best_new, ext2_new),
                                   best_new)
            early = best_new >= vcap
            cont_occ = ver_like & ~early & (survive1 | (pair_ok & survive2))
            cont_from2 = ~survive1 & pair_ok & survive2
            occ_done = ver_like & ~cont_occ
            next_i = occ_i_eff + torch.where(pair_ok, 2, 1)
            more_occ = occ_done & (next_i < cnt_eff) & ~early
            occ_i2 = torch.where(more_occ, next_i,
                                 torch.where(cont_from2, j2, occ_i_eff))
        # orientation handoff: A exhausted and B has occurrences
        cntb_eff = torch.where(is_key, cnt_b, s["cntb"])
        to_b = (occ_done & ~more_occ & (strand == 0) & ~on_b_eff
                & (cntb_eff >= 1) & ~early) | skip_to_b
        ver_resolve = occ_done & ~more_occ & ~to_b

        # SUB cascade (two-strand bitmaps)
        subj = s["subj"]
        key_j = (s["key"] & M32) >> (2 * (k - subj.clamp(1, k)))
        w_idx = key_j >> 5
        bm_row = bm_bases[subj.clamp(0, k - 1)] + (w_idx >> 1)
        brow = bms[torch.where(is_sub, bm_row, 0)]
        bm_word = torch.where((w_idx & 1) == 1, brow[:, 1], brow[:, 0])
        bit_set = ((bm_word >> (key_j & 31)) & 1) == 1
        sub_present = is_sub & bit_set
        sub_down = is_sub & ~bit_set
        subj_next = torch.where(sub_down, subj - 1, subj)
        sub_floor = sub_down & (subj_next <= j0)

        # the phase's matching statistic, when this round resolves it
        m_res = torch.where(floor_case, maxlen, torch.where(
            sub_present, subj, torch.where(sub_floor, j0, k + best_new)))
        resolve = floor_case | sub_present | sub_floor | ver_resolve
        if park:
            m_res = torch.where(is_res, s["inj_m"], m_res)
            resolve = resolve | is_res
        b_res = resolve & is_b
        prefix_match = b_res & (m_res == maxlen)
        to_fwd = b_res & ~prefix_match
        emit = resolve & ~is_b
        onehot = (st_iota[None, :] == nstage[:, None]) & emit[:, None]
        stage_qs.copy_(torch.where(onehot, anc[:, None], stage_qs))
        stage_l.copy_(torch.where(onehot, (m_res + 1)[:, None], stage_l))
        nstage.copy_(torch.where(emit, nstage + 1, nstage))
        emit_done = emit & (anc == 0)
        anc_restart = anc - 1 if overlap == 0 else anc + m_res + overlap
        restart = emit & ~emit_done

        if work is not None:
            tables = (use_meta.long() + (start_a | is_keyb).long()
                      + n_pairs.long() + pair_ok.long() + n_lperm.long()
                      + is_sub.long())
            work.add_(torch.stack([
                active.sum(), tables.sum(),
                ver_like.sum() + pair_ok.sum(),
                (nsym1 + nsym2).sum()]).to(work.device))

        mode2 = torch.where(to_fwd | restart, KEY, mode)
        mode2 = torch.where(k_empty | to_sub_short, SUB, mode2)
        mode2 = torch.where(cont_occ, VER, mode2)
        mode2 = torch.where(more_occ, POS, mode2)
        mode2 = torch.where(to_b, KEYB, mode2)
        if park:
            mode2 = torch.where(k_heavy, PARKED, mode2)
        update(
            active=s["active"] & ~(prefix_match | emit_done),
            fb=s["fb"] | (fb_new & s["active"]),
            dirb=torch.where(to_fwd, 0, torch.where(restart, 1, dirb)),
            anc=torch.where(to_fwd, anc - m_res,
                            torch.where(restart, anc_restart, anc)),
            mode=mode2,
            strand=torch.where(to_fwd | restart, 0,
                               torch.where(to_b, 1, strand)),
            key=torch.where(is_key, key, s["key"]),
            keyb=torch.where(is_key, keyb_new, s["keyb"]),
            cntb=torch.where(is_key, cnt_b, s["cntb"]),
            subj=torch.where(k_empty, k - 1,
                             torch.where(to_sub_short, maxlen, subj_next)),
            cnt=cnt_eff, aux=aux_eff, occ_i=occ_i2, bhi=bhi2,
            llcp=llcp2, rlcp=rlcp2,
            occ_pos=torch.where(cont_occ, torch.where(cont_from2, occ_2nd,
                                                      occ_eff),
                                s["occ_pos"]),
            ext=torch.where(cont_occ,
                            torch.where(cont_from2, ext2_new, ext1_new),
                            torch.where(ver_like | is_key | is_keyb, 0,
                                        s["ext"])),
            best=torch.where(ver_like, best_new,
                             torch.where(is_key, 0, s["best"])))

    def merge():
        """Drain the staged emissions into [Q, cap] in order; a lane past
        cap is flagged overflow and stops."""
        nsfs = s["nsfs"]
        idx = nsfs[:, None] + st_iota[None, :]
        ok = (st_iota[None, :] < nstage[:, None]) & (idx < cap)
        idx = torch.where(ok, idx, cap)
        oq.scatter_(1, idx, torch.where(ok, stage_qs, 0))
        ol.scatter_(1, idx, torch.where(ok, stage_l, 0))
        overflow = s["overflow"] | (nsfs + nstage > cap)
        update(overflow=overflow, nsfs=torch.clamp(nsfs + nstage, max=cap),
               active=s["active"] & ~overflow)
        nstage.zero_()

    graph = None
    r = r0
    while r < max_rounds and bool(runnable().any()):
        stage_at = r
        while (r < max_rounds and r < stage_at + STAGE_EVERY
               and bool((runnable() & (nstage < STAGE_EVERY)).any())):
            if graph is not None:
                graph.replay()
            else:
                round_body()
                if dev.type == "cuda":
                    # the first round ran eagerly (the warm-up); capture
                    # the next one, which replays for every later round
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        round_body()
            r += 1
        merge()
    del graph
    for i, name in enumerate(STATE):
        state[i] = _to_i32(s[name].to(torch.int64))
    out_qs.copy_(oq[:, :cap])
    out_l.copy_(ol[:, :cap])
    rounds.fill_(r)
