"""Search throughput of the port on one card: the JAX repo's bench.py.

    python -m svdss_tpu_torch.tools.bench [--genome-bp 100000000]
        [--reads 4096] [--read-len 10000] [--iters 3] [--smoke]
        [--no-sweep] [--no-host] [--no-pool] [--host-sample 512]
        [--jump-k K] [--engine anchor|fm] [--device cuda|cpu]
        [--workdir build/bench]

Prints ONE JSON line with bench.py's keys:

    {"metric": "sfs_search_reads_per_s_per_chip", "value": N,
     "unit": "reads/s", "engine": ..., "fm_reads_per_s": ...,
     "reads_per_s_by_len": {...}, "smoke_ok": ..., "vs_baseline": R, ...}

The workload is bench.py's, byte for byte: a random genome of --genome-bp
(seed 3; SVDSS_BENCH_GENOME overrides the default of 100 Mbp) and --reads
(SVDSS_BENCH_READS, default 4,096) smoothed-like reads of --read-len
(10 kb) with 0.2% SNVs, 30% of them carrying a 100 bp novel insertion
(seed 5). Every read is eligible, so every lane of every kernel is live.

Measurements, each a host-clock window that ends with the results on the
host (one warm-up call first):

  anchor  the primary engine, kernel K3 (ops/anchor_device.py
          batch_search_anchor) on batches staged on the card, at the
          production round cap max(384, L // 14) and emission cap
          max(512, (L + 1) // 16); the previous batch's incomplete and
          overflow lanes are redone by the host engine after the next
          launch, so the redo overlaps the kernel. The rate is bench.py's,
          the fastest window; with one batch a window (the defaults) the
          first window carries no redo (its batch's redo runs in the
          next), so that rate leaves the redo out. The rate over all
          windows, every redo in them, is logged beside it
  pool    kernel K4 (ops/anchor_pool.py AnchorPool, 8,192 lanes) over a
          stream 4x the batch, cold and then warm, reads uploaded and
          results fetched in the window, host redo included
  fm      kernel K2 (ops/pingpong.py batch_search), with --jump-k first
          building the k-mer table by kernel K6 (ops/fmd.py
          build_jump_table)
  sweep   2 kb and 30 kb reads at auto_q lanes (Q = 16,384 and 1,280 at
          the defaults), on the primary engine
  host    the native host engine (ops/pingpong_native.py) at 1 and 2
          threads on --host-sample reads
  parity  the first 48 lanes of K3, K2 and K5 (the wide engine in
          parked-phase waves over a 4 Mbp slice of the genome, cmax 254,
          heavy resolver) against the host engine (K5: over the slice's
          FMD index, which gives the wide oracle's lists). An unflagged
          lane must equal the host's list, an overflow lane hold its
          first cap SFSs of a longer list, an incomplete one a prefix of
          it, and K3's round-capped lanes, run again without the cap,
          their whole list. --check-all holds every lane instead, and
          also every lane of the sweep's launches and of the pool's
          stream

On the card each kernel is also timed alone by CUDA events at the bench's
shapes, with its launches, the slowest lane's rounds or steps, its work
counts and its least time (tools/common.py's rule): one ``[bench] kernel``
JSON line each on stderr.

Where this departs from bench.py:

- a parity mismatch ends the run with exit code 1 (the JSON line is still
  printed, with smoke_ok false), and an error in the check propagates;
  bench.py catches both and exits 0. Flagged lanes are held too (bench.py
  skips them), K5 against the host engine over the slice (bench.py: the
  wide oracle: the same lists, from Python), and --check-all is new;
- without a card and without ``--device cpu`` it raises
  (utils/device.py resolve_device): no fallback to the CPU, where the
  kernels' plain versions run; bench.py's ``--cpu`` is taken as
  ``--device cpu``;
- the index and anchor-table caches go under --workdir, not beside the
  file;
- K2's jump mode takes no key array: the kernel derives each window's key
  from the read (ops/pingpong.py window_keys), so utils/seq.py kmer_keys
  is not called;
- the pool takes its lanes, width and cap only: the JAX pool's
  rounds_per_step, reservoir, ring and refill size a device reservoir that
  the port's pool has no counterpart of, and its ``rounds_run`` counts the
  rounds of every read (AnchorPool.rounds_run), not lockstep rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import common as C
from ..index.fmd import FMDIndex, build_index, genome_text
from ..ops import anchor_device, anchor_pool, anchor_wide_device as aw
from ..ops.anchor import AnchorIndex, build_anchor_index
from ..ops.anchor_device import batch_search_anchor, build_device_anchor
from ..ops.anchor_pool import AnchorPool
from ..ops.anchor_wide import build_anchor_index_wide, make_heavy_resolver
from ..ops.fmd import DeviceFMDIndex, build_jump_table
from ..ops.pingpong import batch_search
from ..pipeline.search import host_search_batch
from ..utils.device import resolve_device
from ..utils.seq import encode_nt6

FM_CAP = 512            # bench.py's emission cap of K2
WIDE_SLICE = 4_000_000  # the wide parity check's genome slice
WIDE_CMAX = 254
PARITY_LANES = 48


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# -------------------------------------------------------------- workload

def make_genome(genome_bp: int, seed: int = 3) -> np.ndarray:
    """bench.py's random genome (seed 3) as ACGT bytes."""
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, genome_bp)]


def genome_nt6(genome_arr: np.ndarray) -> np.ndarray:
    """ACGT bytes as nt6 codes 1..4."""
    g6 = np.zeros(len(genome_arr), dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        g6[genome_arr == b] = i + 1
    return g6


def build_problem(genome_bp: int, n_reads: int, read_len: int, seed: int = 3,
                  workdir: str = "build/bench"):
    """bench.py's genome (seed 3) and its two-strand FMD index, cached as
    WORKDIR/index_GENOME_BP.npz."""
    cache = os.path.join(workdir, f"index_{genome_bp}.npz")
    genome_arr = make_genome(genome_bp, seed)
    if os.path.exists(cache):
        index = FMDIndex.load(cache)
    else:
        genome = {"bench": genome_arr.tobytes().decode()}
        t0 = time.time()
        index = build_index(genome, threads=2)
        log(f"index build: {time.time() - t0:.1f}s ({index.n} symbols)")
        os.makedirs(workdir, exist_ok=True)
        index.save(cache)
    return index, genome_arr


def make_reads(genome_arr: np.ndarray, n_reads: int, read_len: int,
               seed: int = 5):
    genome_bp = len(genome_arr)
    rng = np.random.default_rng(seed)
    g6 = genome_nt6(genome_arr)
    reads = np.zeros((n_reads, read_len + 1), dtype=np.uint8)
    lens = np.full(n_reads, read_len, dtype=np.int32)
    starts = rng.integers(0, genome_bp - read_len, n_reads)
    reads[:, :read_len] = g6[starts[:, None] + np.arange(read_len)]
    # SNV errors at 0.2%
    n_snv = max(1, int(read_len * 0.002))
    cols = rng.integers(0, read_len, (n_reads, n_snv))
    rows = np.repeat(np.arange(n_reads), n_snv)
    reads[rows, cols.ravel()] = rng.integers(1, 5, n_reads * n_snv)
    # 30% of reads carry a 100bp novel insertion (SV evidence)
    ins_rows = np.nonzero(rng.random(n_reads) < 0.3)[0]
    for i in ins_rows:
        at = int(rng.integers(200, read_len - 200))
        ins = rng.integers(1, 5, 100).astype(np.uint8)
        reads[i, at + 100:read_len] = reads[i, at:read_len - 100].copy()
        reads[i, at:at + 100] = ins
    return reads, lens


def auto_q(n_reads: int, read_len: int, base_budget: int) -> int:
    """Lane count for a read-length bucket: the lane budget is
    symbol-denominated (Q x L ~ const, set at the 10 kb primary shape)."""
    q = max(256, min(n_reads, base_budget // max(read_len, 1)))
    return max(256, (q // 256) * 256)


def build_anchor(genome_arr, genome_bp: int, cmax: int = 16,
                 workdir: str = "build/bench") -> AnchorIndex:
    """The narrow anchor tables of bench.py (cmax 16), cached as
    WORKDIR/anchor_GENOME_BP_CMAX.npz."""
    cache = os.path.join(workdir, f"anchor_{genome_bp}_{cmax}.npz")
    if os.path.exists(cache):
        return AnchorIndex.load(cache)
    genome = {"bench": genome_arr.tobytes().decode()}
    t0 = time.time()
    aidx = build_anchor_index(genome_text(genome), cmax=cmax)
    log(f"anchor build: {time.time() - t0:.1f}s (k={aidx.k})")
    os.makedirs(workdir, exist_ok=True)
    aidx.save(cache)
    return aidx


def anchor_cap(read_width: int, cap: int = 512) -> int:
    """The search stage's length-scaled emission cap."""
    return max(cap, read_width // 16)


def round_cap(read_len: int) -> int:
    """The production round cap for smoothed reads: stragglers past ~p99
    rounds go to the host."""
    return max(384, read_len // 14)


# ---------------------------------------------------------------- timing

def time_device(dev_index: DeviceFMDIndex, reads, lens, iters: int,
                cap: int = FM_CAP, **jump_kw):
    """K2's rate: the batch uploaded once, each window one launch and the
    emission counts fetched."""
    dev = dev_index.device
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    t0 = time.time()
    res = batch_search(dev_index, seqs, lens_t, cap=cap, **jump_kw)
    res.n_sfs.cpu()
    warm = time.time() - t0
    if bool(res.incomplete.any()):
        log("WARNING: incomplete lanes")
    times = []
    for _ in range(iters):
        t0 = time.time()
        res = batch_search(dev_index, seqs, lens_t, cap=cap, **jump_kw)
        res.n_sfs.cpu()
        times.append(time.time() - t0)
    n_sfs = int(res.n_sfs.sum())
    return len(reads) / min(times), warm, n_sfs, times


def time_anchor(didx, params, index, reads, lens, iters: int,
                cap: int = 512, q: int = 0, max_rounds: int = 0):
    """K3's rate including the exact host redo of incomplete and overflow
    lanes: each batch's redo runs on the host after the next batch's launch
    (which returns once queued), so it overlaps that kernel; the last redo
    is drained inside the last window. q > 0 splits the reads into batches
    of q lanes; max_rounds > 0 caps the rounds."""
    cap = anchor_cap(reads.shape[1], cap)
    n = len(reads)
    if q and q < n:
        n = (n // q) * q
        reads, lens = reads[:n], lens[:n]
    else:
        q = n
    dev = didx.device
    # the host engine's one-time table build is not billed to a window
    host_search_batch(index, [reads[0, :64]])
    staged = [(torch.from_numpy(reads[b:b + q]).to(dev),
               torch.from_numpy(lens[b:b + q]).to(dev))
              for b in range(0, n, q)]
    t0 = time.time()
    res = batch_search_anchor(didx, params, *staged[0], cap=cap,
                              max_rounds=max_rounds)
    res.n_sfs.cpu()
    warm = time.time() - t0
    times = []
    n_redo = n_sfs = 0
    pending: List[np.ndarray] = []
    for it in range(iters):
        n_redo = n_sfs = 0
        t0 = time.time()
        for bi, base in enumerate(range(0, n, q)):
            res = batch_search_anchor(didx, params, *staged[bi], cap=cap,
                                      max_rounds=max_rounds)
            if pending:                 # overlaps the queued launch
                host_search_batch(index, pending)
                pending = []
            bad = (res.incomplete | res.overflow).cpu().numpy()
            redo = np.nonzero(bad)[0]
            pending = [reads[base + i, :lens[base + i]] for i in redo]
            n_redo += len(redo)
            n_sfs += int(res.n_sfs.cpu().numpy()[~bad].sum())
        if it == iters - 1 and pending:
            host_search_batch(index, pending)
            pending = []
        times.append(time.time() - t0)
    return n / min(times), warm, n_sfs, times, n_redo


def time_pool(didx, params, index, reads, lens, cap: int = 512,
              lanes: int = 8192, mult: int = 4):
    """The streaming rate of the pool over a read stream `mult` times the
    batch, including read upload, result download and the host redo; cold
    (the kernels' first launch), then warm. Returns (rate, host redos,
    rounds_run, pool launches) of the warm run."""
    enc = pool_stream(reads, lens, mult)
    cold = pool_pass(didx, params, index, enc, cap, lanes)
    dt, redo, rounds, launches, n_sfs = pool_pass(didx, params, index, enc,
                                                  cap, lanes)
    log(f"pool: {len(enc)} reads, cold {cold[0]:.2f}s, warm {dt:.2f}s "
        f"({n_sfs} SFS from the card, {redo} host redos)")
    return len(enc) / dt, redo, rounds, launches


def pool_stream(reads, lens, mult: int = 4) -> List[np.ndarray]:
    """time_pool's read stream: the batch `mult` times over."""
    n0 = len(reads)
    return [reads[i % n0, :lens[i % n0]] for i in range(n0 * mult)]


def pool_pass(didx, params, index, enc: List[np.ndarray], cap: int = 512,
              lanes: int = 8192):
    """One pass of a new pool over the stream `enc`, the reads it flags
    redone by the host engine: (seconds from the pool's first read to the
    last redo, host redos, rounds_run, pool launches, SFSs of the reads
    the card answered)."""
    pool = AnchorPool(didx, params, lanes=lanes,
                      read_len=max(len(e) for e in enc), cap=cap)
    l0 = anchor_pool.launches
    t0 = time.time()
    got = list(pool.run(enc))
    redo = [tag for tag, pairs in got if pairs is None]
    if redo:
        host_search_batch(index, [enc[i] for i in redo])
    return (time.time() - t0, len(redo), pool.rounds_run,
            anchor_pool.launches - l0,
            sum(len(pairs) for _, pairs in got if pairs is not None))


def measure_host_baseline(index, reads, lens, n_sample: int,
                          repeats: int = 3):
    """Native host search on the same workload: the median of repeated 1t
    and 2t runs after a discarded warm run; the 2t rate is capped at twice
    the 1t rate (bench.py's rule for its 2-core host)."""
    from ..ops.pingpong_native import open_native_fmd
    nf = open_native_fmd(index, threads=2)
    if nf is None:
        return None
    n = min(n_sample, len(reads))
    encoded = [reads[i, :lens[i]].copy() for i in range(n)]
    out = {}
    for t in (1, 2):
        nf.search_batch(encoded, threads=t)       # warm (discarded)
        rates = []
        for _ in range(repeats):
            t0 = time.time()
            nf.search_batch(encoded, threads=t)
            rates.append(n / (time.time() - t0))
        out[t] = float(np.median(rates))
    nf.close()
    out[2] = min(out[2], 2 * out[1])
    return out


# ---------------------------------------------------------------- parity

def host_lists(index, reads, lens, n: Optional[int] = None) -> list:
    """The host engine's SFS lists of the first n reads (all by default),
    on every core."""
    n = len(reads) if n is None else n
    return host_search_batch(index, [reads[i, :lens[i]] for i in range(n)],
                             threads=os.cpu_count() or 2)


class Parity:
    """Device lanes held one by one against an exact engine's lists: a
    lane with no flag must equal its list, an overflow lane must hold the
    first `cap` SFSs of a list longer than cap, and an incomplete lane
    (stopped by the round cap before its end) a prefix of its list."""

    def __init__(self):
        self.checked = 0
        self.flagged = {}
        self.mismatched = {}
        self.waves = None      # wide_waves' record, when K5 was checked

    def hold(self, name: str, res, want, cap: int, ids=None,
             finish: bool = False) -> None:
        """The first len(want) lanes of a search result; `ids` names them
        in the mismatch list (their lane numbers by default); with
        `finish` an incomplete lane is a mismatch."""
        got, _ = C.result_lists(res)
        ov = res.overflow.cpu().numpy()
        inc = res.incomplete.cpu().numpy()
        for i, w in enumerate(want):
            g, w = [tuple(p) for p in got[i]], [tuple(p) for p in w]
            if ov[i]:
                ok = len(w) > cap and g == w[:cap]
            elif inc[i]:
                ok = not finish and g == w[:len(g)]
            else:
                ok = g == w
            self.checked += 1
            if ov[i] or inc[i]:
                self.flagged[name] = self.flagged.get(name, 0) + 1
            if not ok:
                self.mismatched.setdefault(name, []).append(
                    i if ids is None else ids[i])

    def hold_lists(self, name: str, got, want) -> None:
        """Lists of a stream (the pool's): None is a read flagged for the
        host (the pool does not say which flag), any other must equal its
        list."""
        for i, (g, w) in enumerate(zip(got, want)):
            self.checked += 1
            if g is None:
                self.flagged[name] = self.flagged.get(name, 0) + 1
            elif [tuple(p) for p in g] != [tuple(p) for p in w]:
                self.mismatched.setdefault(name, []).append(i)

    @property
    def ok(self) -> bool:
        return not self.mismatched


def check_anchor(par: Parity, name: str, didx, params, reads, lens, want,
                 q: int = 0, max_rounds: int = 0) -> None:
    """K3 as time_anchor launches it (batches of q lanes, the round cap)
    on every read of `want`; each lane it flags incomplete is run again
    without the round cap, and must then come to its end."""
    dev = didx.device
    cap = anchor_cap(reads.shape[1])
    q = q or len(want)
    for b in range(0, len(want), q):
        seqs = torch.from_numpy(reads[b:b + q]).to(dev)
        lens_t = torch.from_numpy(lens[b:b + q]).to(dev)
        res = batch_search_anchor(didx, params, seqs, lens_t, cap=cap,
                                  max_rounds=max_rounds)
        par.hold(name, res, want[b:b + q], cap, range(b, b + q))
        late = torch.nonzero(res.incomplete & ~res.overflow).flatten()
        if len(late):
            again = batch_search_anchor(didx, params, seqs[late],
                                        lens_t[late], cap=cap)
            ids = [b + i for i in late.tolist()]
            par.hold(name + "_uncapped", again, [want[i] for i in ids], cap,
                     ids, finish=True)


def check_fm(par: Parity, name: str, dev_index, reads, lens, want,
             **jump_kw) -> None:
    """K2 as time_device launches it (one launch, cap FM_CAP) on every read
    of `want`."""
    dev = dev_index.device
    n = len(want)
    res = batch_search(dev_index, torch.from_numpy(reads[:n]).to(dev),
                       torch.from_numpy(lens[:n]).to(dev), cap=FM_CAP,
                       **jump_kw)
    par.hold(name, res, want, FM_CAP)


def check_pool(par: Parity, didx, params, reads, lens, want,
               lanes: int = 8192, mult: int = 4) -> None:
    """The pool as time_pool runs it, over a stream `mult` times the reads:
    every result of the stream against its read's list."""
    n0 = len(reads)
    enc = pool_stream(reads, lens, mult)
    got = dict(AnchorPool(didx, params, lanes=lanes,
                          read_len=int(lens.max()), cap=512).run(enc))
    par.hold_lists("pool", [got[i] for i in range(len(enc))],
                   [want[i % n0] for i in range(len(enc))])


def wide_slice(genome_arr: np.ndarray):
    """The wide engine's tables over the first 4 Mbp of the genome (cmax
    254), its heavy-k-mer resolver, and the FMD index of the same slice
    (the exact host engine that K5 is held against)."""
    text = genome_arr[:WIDE_SLICE].tobytes().decode()
    widx = build_anchor_index_wide(encode_nt6(text), cmax=WIDE_CMAX)
    return widx, make_heavy_resolver(widx), build_index({"slice": text},
                                                        threads=2)


def wide_waves(widx, wres, reads, lens, dev) -> dict:
    """K5 in parked-phase waves over every lane, each parked phase answered
    by the heavy resolver: the result, the device tables, and the call's
    launches, waves, parked phases answered, work counts and host
    seconds."""
    wdev, wparams = aw.build_device_anchor_wide(widx, dev)
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)

    def resolve(lanes_, ancs, dirbs):
        return np.array(
            [wres(reads[ln, :lens[ln]], int(a),
                  "left" if d == 1 else "right")
             for ln, a, d in zip(lanes_, ancs, dirbs)], dtype=np.int32)

    work = torch.zeros(4, dtype=torch.int64, device=dev)
    l0 = aw.launches
    t0 = time.time()
    run = aw.WideWaveRun(wdev, wparams, seqs, lens_t, resolve,
                         cap=anchor_cap(reads.shape[1]), work=work)
    res = run.finish()
    res.n_sfs.cpu()
    return {"result": res, "tables": (wdev, wparams),
            "record": {
                "shape": f"Q={len(reads)} L+1={reads.shape[1]} "
                         f"cap={anchor_cap(reads.shape[1])}",
                "launches": aw.launches - l0, "seconds": time.time() - t0,
                "waves": run.n_waves, "parked_phases": run.parked_lanes,
                "slowest_lane_rounds": int(res.iters),
                "flagged": int((res.overflow | res.incomplete).sum()),
                "work": dict(zip(aw.WORK_FIELDS, work.tolist()))}}


def parity_check(index, dev_index, didx, params, reads, lens, ns: int,
                 jump_kw: dict, wide=None, max_rounds: int = 0,
                 par: Optional[Parity] = None, want=None) -> Parity:
    """The first ns lanes of K3 (when anchor tables are given; at
    max_rounds, with check_anchor's redo of round-capped lanes), K2 (with
    jump_kw) and, with `wide` = wide_slice(...), the K5 waves, against the
    host engine (K5: over the slice); `want`: the host engine's lists of
    at least ns reads, when they are at hand."""
    par = Parity() if par is None else par
    want = host_lists(index, reads, lens, ns) if want is None else want[:ns]
    if didx is not None:
        check_anchor(par, "anchor", didx, params, reads, lens, want,
                     max_rounds=max_rounds)
    check_fm(par, "fm" + ("_jump" if jump_kw else ""), dev_index, reads,
             lens, want, **jump_kw)
    if wide is not None:
        widx, wres, sidx = wide
        par.waves = wide_waves(widx, wres, reads, lens, dev_index.device)
        par.hold("wide_waves", par.waves["result"],
                 host_lists(sidx, reads, lens, ns),
                 anchor_cap(reads.shape[1]))
    return par


# -------------------------------------------------- kernels on their own

def log_kernel(name: str, rec: dict) -> None:
    log("kernel " + json.dumps({"kernel": name, **rec}))


def k2_record(dev_index, reads, lens, cap: int = FM_CAP, **jump_kw) -> dict:
    """K2 alone on the batch: ms (CUDA events, mean of 3 after a warm-up),
    the slowest lane's steps, rank steps and jump-table rows, and the
    least time (tools/common.py fm_bytes_ops)."""
    dev = dev_index.device
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    res = batch_search(dev_index, seqs, lens_t, cap=cap, work=work,
                       **jump_kw)
    steps, jump_rows = work.tolist()
    ms = C.event_ms(lambda: batch_search(dev_index, seqs, lens_t, cap=cap,
                                         **jump_kw), 3)
    k = jump_kw.get("jump_k", 0)
    nbytes, ops = C.fm_bytes_ops(dev_index, lens_t, steps, res.n_sfs,
                                 jump_kw.get("jump_table"), jump_rows, k)
    bms, by = C.bound_ms(nbytes, ops)
    iters = int(res.iters)
    return {"shape": f"Q={len(lens)} L+1={reads.shape[1]} cap={cap}"
                     + (f" k={k}" if k else ""),
            "launches": 1, "ms": ms, "slowest_lane_steps": iters,
            "us_per_step": ms * 1e3 / max(1, iters), "rank_steps": steps,
            "jump_rows": jump_rows,
            "flagged": int((res.overflow | res.incomplete).sum()),
            "bound_bytes": nbytes, "bound_ms": bms, "bound_by": by}


def k3_record(didx, params, reads, lens, q: int, max_rounds: int,
              n_redo: int) -> dict:
    """K3 alone on the first batch of q lanes, as time_anchor launches it;
    `n_redo` is time_anchor's host redo count over all batches."""
    dev = didx.device
    q = min(q or len(reads), len(reads))
    seqs = torch.from_numpy(reads[:q]).to(dev)
    lens_t = torch.from_numpy(lens[:q]).to(dev)
    cap = anchor_cap(reads.shape[1])
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    res = batch_search_anchor(didx, params, seqs, lens_t, cap=cap,
                              max_rounds=max_rounds, work=work)
    work = work.tolist()
    ms = C.event_ms(lambda: batch_search_anchor(
        didx, params, seqs, lens_t, cap=cap, max_rounds=max_rounds), 3)
    nbytes, ops = C.anchor_bytes_ops(didx, lens_t, work, res.n_sfs, 6 * q + 4)
    bms, by = C.bound_ms(nbytes, ops)
    iters = int(res.iters)
    return {"shape": f"Q={q} L+1={reads.shape[1]} cap={cap} "
                     f"max_rounds={max_rounds}",
            "launches": len(reads) // q, "ms": ms,
            "slowest_lane_rounds": iters,
            "us_per_round": ms * 1e3 / max(1, iters),
            "work": dict(zip(anchor_device.WORK_FIELDS, work)),
            "flagged_first_batch": int((res.overflow | res.incomplete).sum()),
            "host_redo": n_redo, "bound_bytes": nbytes, "bound_ms": bms,
            "bound_by": by}


def k4_record(didx, params, reads, lens, lanes: int, mult: int,
              launches: int, n_redo: int, rounds_run: int) -> dict:
    """K4 alone on the pool's first chunk (2 x lanes reads of the stream),
    and the slowest read's rounds from K3 under the pool's per-read budget
    (which gives K4's results)."""
    dev = didx.device
    n0 = len(reads)
    M = min(2 * lanes, n0 * mult)
    encs = [reads[i % n0, :lens[i % n0]] for i in range(M)]
    syms, offs, lns = (torch.from_numpy(a).to(dev)
                       for a in anchor_pool.pack_chunk(encs))
    Lp1 = int(lens.max()) + 1
    cap = 512
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    got = anchor_pool.pool_search(didx, params, syms, offs, lns, Lp1, cap,
                                  lanes=lanes, work=work)
    work = work.tolist()
    ms = C.event_ms(lambda: anchor_pool.pool_search(
        didx, params, syms, offs, lns, Lp1, cap, lanes=lanes), 3)
    seqs = torch.from_numpy(reads[np.arange(M) % n0]).to(dev)
    budget = anchor_pool.lane_budget(lns).to(torch.int32)
    k3 = batch_search_anchor(didx, params, seqs, lns, cap=cap, budget=budget,
                             max_rounds=int(budget.max()))
    same = bool(torch.equal(k3.n_sfs, got.n_sfs) and torch.equal(
        (k3.incomplete.to(torch.uint8) * anchor_pool.FALLBACK
         | k3.overflow.to(torch.uint8) * anchor_pool.OVERFLOW), got.flags))
    iters = int(k3.iters)
    nbytes, ops = C.anchor_bytes_ops(didx, lns, work, got.n_sfs, 13 * M)
    bms, by = C.bound_ms(nbytes, ops)
    return {"shape": f"M={M} lanes={lanes} L+1={Lp1} cap={cap}",
            "launches": launches, "ms": ms, "slowest_lane_rounds": iters,
            "us_per_round": ms * 1e3 / max(1, iters),
            "work": dict(zip(anchor_device.WORK_FIELDS, work)),
            "k3_under_budget_agrees": same, "host_redo": n_redo,
            "rounds_run": rounds_run, "bound_bytes": nbytes,
            "bound_ms": bms, "bound_by": by}


def k6_record(dev_index, k: int) -> dict:
    """K6 building the k-mer table (k - 1 launches, timed together) and
    its least time (tools/common.py jump_bytes_ops)."""
    ms = C.event_ms(lambda: build_jump_table(dev_index, k), 3)
    touched, kinds = C.jump_table_work(dev_index, k)
    parents = sum(kinds.values())
    nbytes, ops = C.jump_bytes_ops(dev_index, k, touched, parents)
    bms, by = C.bound_ms(nbytes, ops)
    return {"shape": f"k={k} over {dev_index.fused.shape[0]} fused rows",
            "launches": k - 1, "ms": ms, "parents": parents,
            "rows_touched": touched, "bound_bytes": nbytes, "bound_ms": bms,
            "bound_by": by}


# ------------------------------------------------------------------ main

def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int,
                    default=int(os.environ.get("SVDSS_BENCH_GENOME",
                                               100_000_000)))
    ap.add_argument("--reads", type=int,
                    default=int(os.environ.get("SVDSS_BENCH_READS", 4096)))
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="small fixed shape (256 reads x 2 kb, 1 Mbp "
                         "genome), 1 iter, no sweep, host or pool")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the 2 kb / 30 kb read-length rates")
    ap.add_argument("--no-host", action="store_true",
                    help="skip the measured host baseline")
    ap.add_argument("--no-pool", action="store_true",
                    help="skip the streaming pool (one-shot batches only)")
    ap.add_argument("--host-sample", type=int, default=512)
    ap.add_argument("--jump-k", dest="jump_k", type=int, default=0,
                    help="k-mer jump table size (0: none)")
    ap.add_argument("--engine", choices=("anchor", "fm"), default="anchor",
                    help="primary engine (default anchor, the search "
                         "stage's path)")
    ap.add_argument("--check-all", action="store_true",
                    help="hold every lane of every launch at the bench's "
                         "shapes against the host engine, not the first 48")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--workdir", default="build/bench",
                    help="index and anchor-table caches")
    args = ap.parse_args(argv)
    if args.smoke:
        args.genome_bp, args.reads, args.read_len, args.iters = (
            1_000_000, 256, 2_000, 1)
        args.no_sweep = args.no_host = args.no_pool = True
    if args.cpu:
        args.device = "cpu"
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    log(f"device: {dev.type} ({C.card_info(dev).get('device')})")
    if on_card:
        log(f"card: {C.card_info(dev)['gpu']}")

    index, genome_arr = build_problem(args.genome_bp, args.reads,
                                      args.read_len, workdir=args.workdir)
    reads, lens = make_reads(genome_arr, args.reads, args.read_len)
    dev_index = DeviceFMDIndex.from_host(index, dev)
    log(f"index: {index.n} symbols, device table "
        f"{dev_index.nbytes / 2**20:.0f} MiB"
        f"{' (wide)' if dev_index.wide else ''}")
    par = Parity()
    # --check-all: the host engine's lists of every read
    want = host_lists(index, reads, lens) if args.check_all else None
    didx = params = None
    if args.engine != "fm" and index.n < 2 ** 31:
        aidx = build_anchor(genome_arr, args.genome_bp,
                            workdir=args.workdir)
        t0 = time.time()
        didx, params = build_device_anchor(aidx, dev)
        C.sync(dev)
        log(f"anchor tables: {didx.nbytes / 2**30:.2f} GiB (k={params.k}), "
            f"layout and upload {time.time() - t0:.1f}s")
    jump_kw = {}
    if args.jump_k:
        t0 = time.time()
        jt = build_jump_table(dev_index, args.jump_k)
        C.sync(dev)
        log(f"{args.jump_k}-mer jump table: {time.time() - t0:.1f}s")
        jump_kw = dict(jump_table=jt, jump_k=args.jump_k)
        if on_card:
            log_kernel("jump_level", k6_record(dev_index, args.jump_k))

    pool_rate = None
    if didx is not None:
        rc_ = round_cap(args.read_len)
        rate, warm, n_sfs, times, n_redo = time_anchor(
            didx, params, index, reads, lens, args.iters, max_rounds=rc_)
        engine_used = "anchor"
        log(f"one-shot(anchor) {args.read_len}bp: warmup {warm:.1f}s, "
            f"times {['%.3f' % t for t in times]} -> {rate:.1f} reads/s "
            f"({n_sfs} SFS, {n_redo} host-redo); over all windows, "
            f"every redo in them: "
            f"{len(reads) * len(times) / sum(times):.1f} reads/s")
        if on_card:
            log_kernel("anchor_batch", k3_record(
                didx, params, reads, lens, 0, rc_, n_redo))
        if not args.no_pool:
            pool_rate, p_redo, p_rounds, p_launches = time_pool(
                didx, params, index, reads, lens)
            if args.check_all:
                check_pool(par, didx, params, reads, lens, want)
            log(f"pool(anchor, streaming incl transfers): {pool_rate:.1f} "
                f"reads/s ({p_redo} host-redo, {p_rounds} rounds)")
            if on_card:
                log_kernel("anchor_pool", k4_record(
                    didx, params, reads, lens, 8192, 4, p_launches, p_redo,
                    p_rounds))
            engine_used = "anchor-pool" if pool_rate > rate else "anchor"
            rate = max(rate, pool_rate)
        fm_rate, _, _, _ = time_device(dev_index, reads, lens, 1, **jump_kw)
        log(f"fm engine: {fm_rate:.1f} reads/s")
    else:
        rate, warm, n_sfs, times = time_device(dev_index, reads, lens,
                                               args.iters, **jump_kw)
        engine_used = "fm"
        fm_rate = rate
        log(f"primary(fm) {args.read_len}bp: warmup {warm:.1f}s, times "
            f"{['%.3f' % t for t in times]} -> {rate:.1f} reads/s "
            f"({n_sfs} SFS)")
    if on_card:
        log_kernel("pingpong_fm", k2_record(
            dev_index, reads, lens, **jump_kw))

    by_len = {str(args.read_len): round(rate, 1)}
    if not args.no_sweep:
        base_budget = args.reads * args.read_len
        for L in (2_000, 30_000):
            # short reads want more lanes: the read set grows up to 4x
            qb = auto_q(4 * args.reads, L, base_budget)
            r2, l2 = make_reads(genome_arr, max(args.reads, qb), L)
            # the reads time_anchor keeps: whole batches of qb
            n_l = len(r2) if didx is None else len(r2) // qb * qb
            want_l = host_lists(index, r2, l2, n_l) if args.check_all \
                else None
            if didx is not None:
                r_l, w_l, _, _, redo_l = time_anchor(
                    didx, params, index, r2, l2, 2, q=qb,
                    max_rounds=round_cap(L))
                if args.check_all:
                    check_anchor(par, f"anchor_{L}", didx, params, r2, l2,
                                 want_l, qb, round_cap(L))
                if on_card:
                    log_kernel("anchor_batch", k3_record(
                        didx, params, r2, l2, qb, round_cap(L), redo_l))
            else:
                r_l, w_l, _, _ = time_device(dev_index, r2, l2, 1,
                                             **jump_kw)
                if args.check_all:
                    check_fm(par, f"fm_{L}", dev_index, r2, l2, want_l,
                             **jump_kw)
                if on_card:
                    log_kernel("pingpong_fm", k2_record(
                        dev_index, r2, l2, **jump_kw))
            by_len[str(L)] = round(r_l, 1)
            log(f"{L}bp (Q={qb}): {r_l:.1f} reads/s (warmup {w_l:.1f}s)")

    # the standing parity check: a sample of lanes (--check-all: every
    # lane) of each device engine against the exact host engine
    wide = wide_slice(genome_arr)
    parity_check(index, dev_index, didx, params, reads, lens,
                 args.reads if args.check_all
                 else min(PARITY_LANES, args.reads),
                 jump_kw, wide, round_cap(args.read_len), par, want)
    log(f"on-chip parity smoke: {par.checked} lanes checked (incl wide "
        f"waves; flagged {par.flagged}), "
        f"{'ok' if par.ok else 'MISMATCH ' + str(par.mismatched)}")
    if on_card:
        log_kernel("anchor_wide", par.waves["record"])
        # K5 alone, one shot, on the same reads and tables
        one, _, _ = C.k5_oneshot(*par.waves["tables"],
                                 torch.from_numpy(reads).to(dev),
                                 torch.from_numpy(lens).to(dev),
                                 anchor_cap(reads.shape[1]), dev)
        log_kernel("anchor_wide", one)

    cpu_model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu_model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    out = {
        "metric": "sfs_search_reads_per_s_per_chip",
        "value": round(rate, 1),
        "unit": "reads/s",
        "engine": engine_used,
        "fm_reads_per_s": round(fm_rate, 1),
        "genome_bp": args.genome_bp,
        "read_len": args.read_len,
        "reads_per_s_by_len": by_len,
        "host_cpu": cpu_model,
        "smoke_ok": par.ok,
        "smoke_lanes_checked": par.checked,
    }
    if pool_rate is not None:
        out["pool_reads_per_s"] = round(pool_rate, 1)
    if not args.no_host:
        host = measure_host_baseline(index, reads, lens, args.host_sample)
        if host:
            est16 = host[2] * 8
            out["host_reads_per_s_1t"] = round(host[1], 1)
            out["host_reads_per_s_2t"] = round(host[2], 1)
            out["host_reads_per_s_16t_est"] = round(est16, 1)
            out["host_baseline_method"] = \
                "median of 3 runs; 16t = 8 x 2t (2-core host)"
            out["vs_baseline"] = round(rate / est16, 3)
            log(f"host baseline: {host[1]:.1f}/1t {host[2]:.1f}/2t -> 16t "
                f"est {est16:.1f}")
    if "vs_baseline" not in out:
        out["vs_baseline"] = round(rate / 1500.0, 3)
        out["baseline_note"] = ("estimated 1500 reads/s baseline ("
                                + ("--no-host" if args.no_host
                                   else "native lib absent") + ")")
    print(json.dumps(out), flush=True)
    return 0 if par.ok else 1


if __name__ == "__main__":
    sys.exit(main())
