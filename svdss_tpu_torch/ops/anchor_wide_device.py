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
to the host whole. A WideWaveRun also takes a batch split over several
devices (parallel/mesh.py) and runs its shards' waves in step, as one
batch.

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

from .. import trace
from .anchor_wide import AnchorIndexWide
from .pingpong import PingPongResult, gather_results
from ..utils.device import (check_launch, load_kernels, on_device,
                            resolve_device, stream_handle)

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


PACK_ROWS = 1 << 12   # span rows packed at a time by pack_text2


def pack_text2(text: np.ndarray, rows: int = PACK_ROWS
               ) -> Tuple[np.ndarray, np.ndarray]:
    """nt6 uint8 [n] -> ([n//256 + 1, 32] int32 2-bit span rows, badrow
    bits as int32). Symbol value = nt6 - 1 for ACGT; any other symbol, and
    any position past the text, is 0 in the rows and flags every row that
    covers it.

    Row m is the 2-bit words of the 256-symbol blocks m and m + 1, so the
    rows are packed `rows` at a time from their blocks plus the next one
    (a 256-symbol overlap), in uint8 and uint32 only: beside the output
    (0.5 B a symbol) a chunk's transients stay ~15 MiB at any n."""
    n = len(text)
    nrow = n // STRIDE2 + 1
    words = np.empty((nrow, SPAN2_W), dtype=np.uint32)
    rowbad = np.empty(nrow, dtype=bool)
    shifts = np.arange(16, dtype=np.uint32) * 2
    for a in range(0, nrow, rows):
        b = min(a + rows, nrow)
        lo, hi = a * STRIDE2, (b + 1) * STRIDE2   # blocks a .. b
        sym = np.zeros(hi - lo, dtype=np.uint8)
        got = text[lo:min(hi, n)]
        sym[:len(got)] = got
        bad = (sym < 1) | (sym > 4)
        bad[len(got):] = True
        sym -= 1
        sym[bad] = 0
        blk = (sym.reshape(-1, 16).astype(np.uint32) << shifts).sum(
            axis=1, dtype=np.uint32).reshape(b - a + 1, 16)
        words[a:b, :16] = blk[:-1]
        words[a:b, 16:] = blk[1:]
        blkbad = bad.reshape(b - a + 1, STRIDE2).any(axis=1)
        rowbad[a:b] = blkbad[:-1] | blkbad[1:]
    bits = np.packbits(rowbad, bitorder="little")
    bw = np.zeros(((nrow + 31) // 32) * 4, dtype=np.uint8)
    bw[:len(bits)] = bits
    return words.view(np.int32), bw.view(np.int32)


UPLOAD_WORDS = 1 << 26   # 32-bit words a host-to-device copy takes at a time
CT_KEYS = 1 << 24        # keys of the fused count table made at a time


def _put_words(a: np.ndarray, dev: torch.device, n_words: int = 0
               ) -> torch.Tensor:
    """The raw bytes of a contiguous array as a 1-D int32 tensor on `dev`
    (so uint32 entries keep their bit patterns, and packed uint8 / uint16
    entries are read four / two a word), zero-filled to `n_words` words or
    to the last whole word. Copied a chunk at a time from a view of `a`: no
    host copy of `a` is made, whatever its size."""
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    n_words = max(n_words, -(-len(raw) // 4))
    out = torch.zeros(n_words, dtype=torch.int32, device=dev)
    step = 4 * UPLOAD_WORDS
    for lo in range(0, len(raw), step):
        c = raw[lo:lo + step]
        if len(c) % 4:
            c = np.concatenate([c, np.zeros(-len(c) % 4, dtype=np.uint8)])
        c = c.view(np.int32)
        out[lo // 4:lo // 4 + len(c)] = torch.from_numpy(
            c if c.flags.writeable else c.copy())
    return out


def _put_counts(cnts: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint8 / uint16 forward counts as an int32 tensor on `dev`, widened a
    chunk at a time."""
    out = torch.empty(len(cnts), dtype=torch.int32, device=dev)
    for lo in range(0, len(cnts), UPLOAD_WORDS):
        out[lo:lo + UPLOAD_WORDS] = torch.from_numpy(
            cnts[lo:lo + UPLOAD_WORDS].astype(np.int32))
    return out


def fused_counts(cnts: np.ndarray, k: int, ct16: bool,
                 dev: torch.device) -> torch.Tensor:
    """The fused count table (forward count | two-strand total a key,
    saturated; 8|8 two keys a word when ct16, else 16|16), made on `dev`
    from the uploaded counts CT_KEYS keys at a time."""
    cf = _put_counts(cnts, dev)
    nk = 1 << (2 * k)
    ct = torch.empty(nk // 2 if ct16 else nk, dtype=torch.int32, device=dev)
    for lo in range(0, nk, CT_KEYS):
        hi = min(lo + CT_KEYS, nk)
        keys = torch.arange(lo, hi, device=dev, dtype=torch.int64)
        c = cf[lo:hi].long()
        tot = c + cf[_rc_key(keys, k)].long()
        if ct16:
            ctw = c.clamp(max=255) | (tot.clamp(max=255) << 8)
            ct[lo // 2:hi // 2] = _to_i32(ctw[0::2] | (ctw[1::2] << 16))
        else:
            ct[lo:hi] = _to_i32(c.clamp(max=65535)
                                | (tot.clamp(max=65535) << 16))
    return ct


@trace.traced("tables: wide layout+upload")
def build_device_anchor_wide(widx: AnchorIndexWide, device=None
                             ) -> Tuple[DeviceAnchorWide, WideParams]:
    """The device tables of host wide tables on `device` (cuda unless asked
    otherwise), with the JAX package's choices: the fused count format
    (8|8 when cmax <= 254, else 16|16), uint8 or uint16 lperm, sorted or
    right-order-only buckets. Every table goes up a chunk at a time from
    the host arrays themselves, so at genome scale (a 3.1G-entry poslist)
    the host holds no second copy of any of them."""
    dev = resolve_device(device)
    k, j0 = widx.k, widx.j0
    pl = widx.poslist
    if pl.dtype != np.uint32:
        raise TypeError("the wide poslist must be uint32")
    bm_parts, bm_bases, row = [], [], 0
    for j in range(j0 + 1, k):
        bm = np.asarray(widx.levels[j], dtype=np.uint32)
        if len(bm) % 2:
            bm = np.concatenate([bm, np.zeros(1, dtype=bm.dtype)])
        bm_parts.append(bm)
        bm_bases.append(row)
        row += len(bm) // 2
    bms = (np.concatenate(bm_parts) if bm_parts
           else np.zeros(2, dtype=np.uint32))
    text2, badrow = pack_text2(widx.text)
    sorted_b = widx.leftidx is not None or widx.right_sorted
    right_only = sorted_b and widx.leftidx is None
    l16 = widx.leftidx is not None and widx.leftidx.dtype == np.uint16
    has_lperm = widx.leftidx is not None and len(widx.leftidx)
    ct16 = widx.cmax <= 254
    index = DeviceAnchorWide(
        ct=fused_counts(widx.cnts, k, ct16, dev),
        aux=_put_words(np.asarray(widx.aux, dtype=np.uint32), dev),
        pospairs=_put_words(pl, dev, 2 * -(-max(len(pl), 1) // 2))
        .reshape(-1, 2),
        bms=_put_words(bms, dev).reshape(-1, 2),
        text2=_put_words(text2, dev).reshape(-1, SPAN2_W),
        badrow=_put_words(badrow, dev),
        lperm=_put_words(widx.leftidx, dev) if has_lperm
        else torch.zeros(1, dtype=torch.int32, device=dev))
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
             chunks: Optional[torch.Tensor] = None,
             done_r: Optional[torch.Tensor] = None) -> None:
    """Run every runnable lane from round `r0` until it ends, parks (with
    `park`) or reaches `max_rounds`; `state`, `out_qs`, `out_l` are updated
    in place and `rounds` ([1] int32) ends as the round at which the last
    lane stopped (at least r0). `done_r` (int32 [Q], optional) takes the
    round after which a lane stopped, for each lane that stops in this
    wave; the others keep theirs. On a CUDA tensor this is one launch of
    K5; on a CPU tensor the plain version (`chunks`: the read rows of
    `read_chunks`, built once per batch)."""
    if done_r is not None and (done_r.dtype != torch.int32
                               or done_r.shape != lens.shape
                               or done_r.device != lens.device
                               or not done_r.is_contiguous()):
        raise TypeError("done_r must be a contiguous int32 [Q] tensor on "
                        "the reads' device")
    if seqs.is_cuda:
        _launch(index, params, seqs, lens, state, out_qs, out_l, rounds, r0,
                cap, max_rounds, overlap, park, work, done_r)
    else:
        if chunks is None:
            chunks = read_chunks(seqs, lens)
        run_wave_plain(index, params, chunks, lens, state, out_qs, out_l,
                       rounds, r0, cap, max_rounds, overlap, park, work,
                       done_r)


def _launch(index, params, seqs, lens, state, out_qs, out_l, rounds, r0,
            cap, max_rounds, overlap, park, work, done_r=None) -> None:
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
        done_r.data_ptr() if done_r is not None else None,
        stream_handle(dev))
    check_launch(rc, "anchor_wide")
    launches += 1


# ------------------------------------------------------------ entry points

def batch_search_anchor_wide(index: DeviceAnchorWide, params: WideParams,
                             seqs: torch.Tensor, lens: torch.Tensor,
                             cap: int = 128, max_rounds: int = 0,
                             overlap: int = -1,
                             work: Optional[torch.Tensor] = None,
                             debug_hist: bool = False):
    """Wide anchor-verify ping-pong over a padded read batch, one shot:
    lanes that land on a heavy k-mer come back incomplete.

    seqs: [Q, L+1] uint8 nt6, 0-padded; lens: [Q] int32. max_rounds=0
    means 8*L + 64. work: optional int64 [4] tensor to which the
    `WORK_FIELDS` counts are added (a measurement aid). With debug_hist
    the result comes as (result, done_r), done_r the JAX package's
    per-lane stop round (int32 [Q]): the round after which a lane stopped
    (an overflowed lane: the round of the merge that found it), -1 if it
    never did."""
    _check(index, params, seqs, lens, cap, work)
    Q, Lp1 = seqs.shape
    seqs, lens = seqs.contiguous(), lens.contiguous()
    state = reset_state(seqs, lens)
    out_qs = torch.zeros((Q, cap), dtype=torch.int32, device=seqs.device)
    out_l = torch.zeros_like(out_qs)
    rounds = torch.zeros(1, dtype=torch.int32, device=seqs.device)
    done_r = torch.full((Q,), -1, dtype=torch.int32, device=seqs.device) \
        if debug_hist else None
    run_wave(index, params, seqs, lens, state, out_qs, out_l, rounds, 0,
             cap, max_rounds or default_max_rounds(Lp1), overlap, False,
             work, done_r=done_r)
    res = result_of(state, out_qs, out_l, rounds)
    return (res, done_r) if debug_hist else res


Resolver = Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]


class WaveLanes:
    """One device's share of a WideWaveRun's lanes: its copy of the
    tables, its reads, and the lanes' state and emissions, all on the
    reads' device."""

    def __init__(self, index: DeviceAnchorWide, seqs: torch.Tensor,
                 lens: torch.Tensor, cap: int):
        Q = seqs.shape[0]
        dev = seqs.device
        self.index = index
        self.seqs, self.lens = seqs.contiguous(), lens.contiguous()
        # the plain version reads the rows of the JAX layout: pack once
        self.chunks = None if seqs.is_cuda else read_chunks(self.seqs,
                                                            self.lens)
        self.state = reset_state(self.seqs, self.lens)
        self.out_qs = torch.zeros((Q, cap), dtype=torch.int32, device=dev)
        self.out_l = torch.zeros_like(self.out_qs)
        self.rounds = torch.zeros(1, dtype=torch.int32, device=dev)

    def snapshot(self) -> Tuple[np.ndarray, int]:
        """The lanes' (mode, anc, dirb, fb, active) as a [5, Q] host array
        and the round count, pulled in one copy (it waits for the wave)."""
        rows = [S["mode"], S["anc"], S["dirb"], S["fb"], S["active"]]
        snap = torch.cat([self.state[rows].reshape(-1),
                          self.rounds]).cpu().numpy()
        return snap[:-1].reshape(5, -1), int(snap[-1])

    def result(self) -> PingPongResult:
        return result_of(self.state, self.out_qs, self.out_l, self.rounds)


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
    iters is the final total.

    `index`, `seqs` and `lens` may instead be lists, one entry a shard of
    the batch on its own device (parallel/mesh.py), all of one padded
    width: shard i holds the lanes after those of shards 0..i-1 as a
    `WaveLanes`. The shards run in step, as one batch would: every wave
    starts on every shard from the same round count, the largest shard's,
    one ``resolve_phases`` call answers the parked phases of all of them
    with lane numbers of the whole batch, and the result's fields are the
    shards' in lane order on the first shard's device. Construction
    launches every shard's first wave before any is waited on, so
    distinct cards overlap."""

    def __init__(self, index, params: WideParams, seqs, lens,
                 resolve_phases: Resolver, cap: int = 128,
                 max_rounds: int = 0, overlap: int = -1,
                 park_limit: int = 16, work: Optional[torch.Tensor] = None):
        if isinstance(seqs, torch.Tensor):
            index, seqs, lens = [index], [seqs], [lens]
        for i, s, ln in zip(index, seqs, lens):
            _check(i, params, s, ln, cap, work)
        if len({s.shape[1] for s in seqs}) != 1:
            raise ValueError("the shards must share one padded width")
        self.params = params
        self.resolve_phases = resolve_phases
        self.cap, self.overlap, self.park_limit = cap, overlap, park_limit
        self.max_rounds = max_rounds or default_max_rounds(seqs[0].shape[1])
        self.work = work
        self.parks = np.zeros(sum(s.shape[0] for s in seqs), dtype=np.int64)
        self.n_waves = 0        # waves that resolved at least one phase
        self.parked_lanes = 0   # phases answered on the host
        self._done = False
        self.shards = []
        for i, s, ln in zip(index, seqs, lens):
            with on_device(s.device):
                self.shards.append(WaveLanes(i, s, ln, cap))
                self._wave(self.shards[-1], 0)

    def _wave(self, sh: WaveLanes, r0: int) -> None:
        run_wave(sh.index, self.params, sh.seqs, sh.lens, sh.state,
                 sh.out_qs, sh.out_l, sh.rounds, r0, self.cap,
                 self.max_rounds, self.overlap, True, self.work, sh.chunks)

    def service(self) -> bool:
        """Advance by one wave; returns False once the run is complete."""
        if self._done:
            return False
        snaps = [sh.snapshot() for sh in self.shards]
        mode, anc, dirb, fbv, act = np.concatenate([a for a, _ in snaps], 1)
        rounds = max(r for _, r in snaps)
        spans = np.cumsum([0] + [a.shape[1] for a, _ in snaps])
        lanes = np.flatnonzero((act != 0) & (fbv == 0) & (mode == PARKED))
        if lanes.size == 0:
            self._done = True
            return False
        fbv = fbv.copy()
        if rounds >= self.max_rounds:
            # the round budget is spent with phases still parked: those
            # lanes are redone on the host
            fbv[lanes] = 1
            for sh, a, b in zip(self.shards, spans[:-1], spans[1:]):
                sh.state[S["fb"]] = torch.from_numpy(fbv[a:b]).to(
                    sh.state.device)
            self._done = True
            return False
        self.parks[lanes] += 1
        over = self.parks[lanes] > self.park_limit
        good = lanes[~over]
        mode = mode.copy()
        inj = np.zeros(mode.shape[0], dtype=np.int32)
        if good.size:
            self.n_waves += 1
            self.parked_lanes += int(good.size)
            inj[good] = self.resolve_phases(good, anc[good], dirb[good])
            mode[good] = RESOLVED
        fbv[lanes[over]] = 1
        push = torch.from_numpy(np.stack([mode, inj, fbv]).astype(np.int32))
        for sh, a, b in zip(self.shards, spans[:-1], spans[1:]):
            sh.state[[S["mode"], S["inj_m"], S["fb"]]] = push[:, a:b].to(
                sh.state.device)
        for sh in self.shards:
            with on_device(sh.state.device):
                self._wave(sh, rounds)
        return True

    def result(self) -> PingPongResult:
        """Final results; valid once service() has returned False."""
        if len(self.shards) == 1:
            return self.shards[0].result()
        return gather_results([sh.result() for sh in self.shards])

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
                   work: Optional[torch.Tensor] = None,
                   done_r: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of kernel K5: the JAX package's round body
    (anchor_wide_jax._make_round_body_wide), emission merge
    (_merge_stage_wide) and while-loops, written out over [Q] int64
    tensors on its span-row layout. All lanes advance in lockstep;
    emissions are staged and merged every 8 rounds from `r0`, when
    overflowed lanes stop. A round updates the lane tensors in place, so
    on a CUDA tensor the rounds after the first replay one captured CUDA
    graph of the round's ops. `done_r` (int32 [Q], optional) takes the
    JAX package's stop round of each lane that stops here: the round
    after which it stopped or was flagged for the host, or for an
    overflowed lane the round of the merge that found it."""
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
    if done_r is not None:
        # the stop rounds, and the round count inside the captured graph
        stop_r = done_r.to(torch.int64)
        rnum = torch.full((1,), r0, dtype=torch.int64, device=dev)

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
        active2 = s["active"] & ~(prefix_match | emit_done)
        fb2 = s["fb"] | (fb_new & s["active"])
        if done_r is not None:
            stop = s["active"] & ~s["fb"] & (~active2 | fb2)
            stop_r.copy_(torch.where(stop & (stop_r < 0), rnum + 1, stop_r))
            rnum.add_(1)
        update(
            active=active2,
            fb=fb2,
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
        if done_r is not None:
            stop_r.copy_(torch.where((stop_r < 0) & overflow, rnum, stop_r))
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
    if done_r is not None:
        done_r.copy_(stop_r)
