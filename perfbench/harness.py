"""One run of a cell: set-up, the measured window, then the check.

Set-up (counted in ``setup_s``, from the process's start to the first
hand-off, less the tables' build): the configuration's reference from its
seed; its FMD index and anchor tables, built by the program's own
``index`` path as ``cli run`` builds them (``build_index``,
``cli._build_anchor``) and kept under the cell's cache directory, so that
only a checkout's first run builds them (that build is reported on a line
of its own and left out of ``setup_s``, as the reference's index is built
once and reused across samples); loading them; the sample's reads from the run's seed; the searcher
(``pipeline.search._DeviceSearcher``: device tables laid out and
uploaded, the engine chosen by the program's own gate); the host engine
opened; and one batch driven through the searcher's loop from end to end,
which warms every shape the window uses (the window replays the same reads
in the same order). The repository's native library is loaded first in
every set-up (built by ``io/native.py`` when the checkout lacks it, that
build also left out of ``setup_s``): without it the host redo would run
the Python engine, so a run that cannot load it stops with no result.

The program runs at ``Config()``, as ``cli run`` takes it, but for one
knob of the traffic mix: ``"pool": false`` runs ``Config(pool=False)``, as
``cli run --no-pool`` does. The configuration's optional ``"wide"`` (false
by default) states which anchor tables ``cli run`` builds for it; a run
whose configuration states otherwise than the program's gate is refused.

The window: batches of the mix are handed, in order, to the driver of the
loop ``run_search`` runs for the searcher (`driver.driver_for`: the pool's,
or the bucketed one-shot loop's, whose window is one stream), the read set
replayed, for ``seconds`` of the host clock; then the driver finishes (the
reads handed in the window are all waited for; the one-shot loop ends its
stream there, as ``run_search`` ends its input). With ``trace`` the window
and the finish run under torch.profiler, and the one-shot engines count
their work (`engines.OneShotWork`): only a traced run calls K2, K3 and K5
with their work counters, so ``k3_roofline`` times that variant of K3,
while the pool's K4 counts in every run.

The check, after the device's peak memory is read and the program's state
freed: the merged SFS lists of a sample of reads drawn from the seed (with
the longest read), of every replay of them, and of reads the host engine
redid, against the plain reference (`reference.py`); and every read handed
in answered.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import resource
import sys
import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import engines, reference, trace as tracemod, traffic
from .driver import driver_for
from .spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "svdss_tpu")
WINDOW_LABEL = "perfbench: window"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the port may not load, compared whole: ``svdss_tpu_torch`` is not
    ``svdss_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cache_dirs(root: str) -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    base = os.path.join(root, "perfbench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


# ---------------------------------------------------------------- set-up

def native_library() -> Optional[float]:
    """Load the repository's native library (``io/native.py`` ``load``,
    which builds it where the checkout lacks it): the seconds of that
    build, or None when the library was there. Without it the run is
    refused, before any result."""
    from svdss_tpu_torch.io import native
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))))
    there = os.path.exists(os.path.join(here, "native", "libsvdss_native.so"))
    t0 = time.perf_counter()
    lib = native.load()
    if lib is None:
        # the host redo would run the Python engine, hours a window: a
        # different host engine from the one cli run uses
        raise RuntimeError(
            "the native library is absent and could not be built: the "
            "host redo would run its Python engine, not cli run's")
    if there:
        return None
    built = time.perf_counter() - t0
    log(f"native library built in {built:.3f} s (not in setup_s)")
    return built


def check_wide(cell: Cell) -> None:
    """Refuse a configuration whose stated ``wide`` (false by default)
    differs from the tables ``cli run`` builds for it (``cli._wide_anchor``,
    which reads the sequences' lengths alone)."""
    from svdss_tpu_torch import cli
    ref = cell.config["reference"]
    stated = bool(cell.config.get("wide", False))
    if cli._wide_anchor({ref["name"]: range(int(ref["length_bp"]))}) \
            != stated:
        raise RuntimeError(
            f"the configuration states {'wide' if stated else 'narrow'} "
            f"anchor tables, but cli run would build "
            f"{'narrow' if stated else 'wide'} ones")


def tables(cell: Cell, genome: np.ndarray, cfg) -> Tuple[object, object,
                                                         Optional[float]]:
    """(FMD index, host anchor tables, seconds of the build or None when
    they were cached). Built as `cli run` builds them, saved beside each
    other as `cli run` saves them."""
    from svdss_tpu_torch import cli
    from svdss_tpu_torch.index.fmd import FMDIndex, build_index
    check_wide(cell)
    d = cell.cache_dir
    os.makedirs(d, exist_ok=True)
    index_path = os.path.join(d, "index.fmd.npz")
    ready = os.path.join(d, "TABLES_READY")
    built = None
    if not os.path.exists(ready):
        t0 = time.perf_counter()
        chroms = traffic.reference_chroms(cell.config, genome)
        index = build_index(chroms, threads=cfg.threads)
        index.save(index_path + ".tmp")
        os.replace(index_path + ".tmp.npz", index_path)
        del index
        cli._build_anchor(chroms, index_path, cfg.anchor_cmax)
        del chroms
        with open(ready, "w") as f:
            f.write("built\n")
        built = time.perf_counter() - t0
        log(f"index and anchor tables built in {built:.3f} s -> {d}")
    index = FMDIndex.load(index_path)
    anchor = cli._load_anchor(cfg, index_path)
    return index, anchor, built


def presence(cell: Cell, genome: np.ndarray,
             device: torch.device) -> reference.Presence:
    """The plain reference's j-mer bitmaps of the configuration, kept
    beside the program's tables."""
    path = os.path.join(cell.cache_dir, "presence.npz")
    if os.path.exists(path):
        return reference.Presence.load(path)
    fwd, rev = reference.strand_symbols(genome)
    pres = reference.Presence.build(fwd, rev, device)
    os.makedirs(cell.cache_dir, exist_ok=True)
    pres.save(path)
    return pres


class Setup:
    """What set-up leaves for the window: the program's searcher, the
    driver of its loop and the run's reads. The program runs at `cfg`, by
    default ``Config()`` as ``cli run`` takes it (a test's tiny genome asks
    for an engine by name), with the mix's ``pool``."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 t_start: float, cfg=None):
        from svdss_tpu_torch.config import Config
        from svdss_tpu_torch.pipeline import search
        self.cell, self.seed, self.device = cell, seed, device
        steps = {}
        t = time.perf_counter()

        def step(name: str) -> None:
            nonlocal t
            now = time.perf_counter()
            steps[name] = now - t
            t = now
        self.cfg = Config() if cfg is None else cfg
        if not cell.traffic.get("pool", True):
            self.cfg = dataclasses.replace(self.cfg, pool=False)
        # the index builder and the host engine only look for the library
        native_s = native_library()
        step("native")
        self.genome = traffic.reference_nt6(cell.config)
        step("reference")
        index, anchor, self.build_s = tables(cell, self.genome, self.cfg)
        self.index = index
        step("tables")
        self.reads = traffic.make_reads(self.genome, cell.traffic, seed)
        self.names = self.reads.names()
        step("reads")
        self.searcher = search._DeviceSearcher(index, self.cfg, device,
                                               anchor)
        # the reads stand for a smoothed BAM's eligible ones: run_search
        # sets this for such an input (the one-shot round cap)
        self.searcher.smoothed_input = self.cfg.putative
        sync(device)
        step("searcher")
        self.driver_cls = driver_for(self.searcher, self.cfg)
        self.table_upload_s = steps["searcher"]
        del anchor
        gc.collect()
        # the host engine opens its native index at its first call
        search.host_search_batch(index, self.reads.reads[:1],
                                 self.cfg.overlap, self.cfg.threads)
        step("host_engine")
        # the kernel, the copies and a full chunk's or batch's buffers:
        # reads without an SV (they rarely go to the host redo)
        plain = np.flatnonzero(self.reads.sv_kind < 0)[:2 * self.cfg.lanes]
        warm = self.driver_cls(self.searcher, self.cfg, keep=lambda t: False)
        warm.hand([(self.names[i], self.reads.reads[i], 0) for i in plain])
        warm.finish()
        del warm
        sync(device)
        step("warm_up")
        self.steps = steps
        self.setup_s = (time.perf_counter() - t_start
                        - (self.build_s or 0.0) - (native_s or 0.0))

    def reseed(self, seed: int) -> None:
        """Another sample's reads for the same searcher (the control's
        runs, several seeds in one process)."""
        self.seed = seed
        self.reads = traffic.make_reads(self.genome, self.cell.traffic, seed)
        self.names = self.reads.names()

    @property
    def batch_reads(self) -> int:
        return int(self.cell.traffic["batch_reads"])

    def batch(self, b: int) -> List[Tuple[str, np.ndarray, int]]:
        """Batch b of the replayed read set."""
        n = len(self.reads.reads)
        i0 = (b * self.batch_reads) % n
        return [(self.names[i], self.reads.reads[i], 0)
                for i in range(i0, i0 + self.batch_reads)]


# ---------------------------------------------------------------- window

class Window:
    """One measured window of closed-loop batches, and the driver's finish
    after it."""

    def __init__(self, setup: Setup, seconds: float, trace: bool,
                 keep, trace_path: str):
        self.setup, self.seconds = setup, seconds
        dev = setup.device
        tracing = trace and dev.type == "cuda"
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if tracing else contextlib.nullcontext())
        span = ((lambda name: torch.profiler.record_function(name))
                if tracing else None)
        launches0 = engines.launches()
        self.driver = d = setup.driver_cls(setup.searcher, setup.cfg,
                                           keep=keep, span=span)
        self.batches: List[Tuple[int, int, float]] = []  # first, n, hand-off
        self.work = engines.OneShotWork(dev) if trace else None
        with prof, (self.work or contextlib.nullcontext()):
            if tracing:
                # the profiler takes its buffers at the first CUDA call it
                # sees: before the window, not in it
                torch.ones(1, device=dev).add_(1)
                sync(dev)
            label = (torch.profiler.record_function(WINDOW_LABEL)
                     if tracing else contextlib.nullcontext())
            with label:
                self.t0 = time.perf_counter()
                self.deadline = self.t0 + seconds
                b = 0
                while time.perf_counter() < self.deadline:
                    batch = setup.batch(b)
                    self.batches.append((d.nreads, len(batch),
                                         time.perf_counter()))
                    d.hand(batch)
                    b += 1
            d.finish()
            sync(dev)
        self.launches = {k: n - launches0[k]
                         for k, n in engines.launches().items()}
        self.analysis = None
        if tracing:
            prof.export_chrome_trace(trace_path)
            try:
                self.analysis = tracemod.analyse(
                    tracemod.load(trace_path), WINDOW_LABEL, seconds,
                    engines.KERNELS)
            finally:
                os.remove(trace_path)

    def k4_work(self) -> Optional[Dict[str, int]]:
        """The anchor work counters (rounds, table rows, text rows,
        compared symbols) summed over the window's pools, or None when the
        run took no pool or the pool keeps none."""
        from svdss_tpu_torch.ops.anchor_device import WORK_FIELDS
        pools = getattr(self.driver, "pools", [])
        if not pools:
            return None
        tot = np.zeros(len(WORK_FIELDS), dtype=np.int64)
        for p in pools:
            w = getattr(p, "_work", None)
            if w is None:
                return None
            tot += w.cpu().numpy()
        return dict(zip(WORK_FIELDS, (int(x) for x in tot)))

    def one_shot(self, kernel: str) -> Optional[Dict[str, int]]:
        """K2's, K3's or K5's work counters over the window and its finish
        (a traced run's), or None."""
        return None if self.work is None else self.work.sums(kernel)


def context(setup: Setup, win: Window) -> types.SimpleNamespace:
    """Everything the metric readers read."""
    d = win.driver
    n = d.nreads
    set_n = len(setup.reads.reads)
    lengths = setup.reads.lengths[np.arange(n) % set_n]
    hand_at = np.empty(n)
    for first, m, t in win.batches:
        hand_at[first:first + m] = t
    s = setup.searcher
    tables = engines.table_bytes(s.anchor, s.dev, s.jump_table)
    # the one-shot engines' launches, and in a traced run their work
    # counters and lanes: k2_*, k3_*, k5_*
    one_shot = {}
    for k in ("K2", "K3", "K5"):
        one_shot[f"{k.lower()}_launches"] = win.launches[k]
        one_shot[f"{k.lower()}_work"] = win.one_shot(k)
        one_shot[f"{k.lower()}_lanes"] = (win.work.lanes[k]
                                          if win.work is not None else None)
    return types.SimpleNamespace(
        seconds=win.seconds, t0=win.t0, deadline=win.deadline,
        setup_s=setup.setup_s, build_s=setup.build_s,
        table_upload_s=setup.table_upload_s,
        lengths=lengths, hand_at=hand_at,
        done_at=np.asarray(d.done_at, dtype=np.float64),
        reads=n, redone=len(d.redone), redo_s=d.redo_s, call_s=d.call_s,
        pool_s=getattr(d, "pool_s", None),
        emissions=d.pairs_out, trace=win.analysis, tables_bytes=tables,
        launches=win.launches,
        k4_work=win.k4_work(), k4_launches=win.launches["K4"],
        k4_table_bytes=tables.get("small"),
        k4_text_bytes=tables.get("text_words"), **one_shot)


# ----------------------------------------------------------------- check

def sample_of(setup: Setup) -> set:
    """Set indices of the reads checked on every replay: a sample drawn
    from the seed, and the longest read."""
    n = len(setup.reads.reads)
    rng = traffic.rng_for(setup.seed, 1)
    want = min(n, int(setup.cell.traffic["check"]["sample_reads"]))
    sample = set(int(i) for i in rng.choice(n, want, replace=False))
    sample.add(int(np.argmax(setup.reads.lengths)))
    return sample


def redone_of(setup: Setup, win: "Window") -> set:
    """Set indices of reads the host engine redid, at most the mix's
    number of them, drawn from the seed."""
    n = len(setup.reads.reads)
    cap = int(setup.cell.traffic["check"]["redo_reads"])
    redone = sorted({o % n for o in win.driver.redone})
    if len(redone) > cap:
        pick = traffic.rng_for(setup.seed, 2).choice(len(redone), cap,
                                                     replace=False)
        redone = [redone[i] for i in sorted(pick)]
    return set(redone)


def reference_lists(setup: Setup, idx: List[int], device: torch.device,
                    verify: bool = True) -> Dict[int, list]:
    """The plain reference's merged lists of the set's reads `idx`
    (verify=False: the control's, see reference.py)."""
    pres = presence(setup.cell, setup.genome, device)
    fwd, _ = reference.strand_symbols(setup.genome)
    return dict(zip(idx, reference.sfs_lists(
        [setup.reads.reads[i] for i in idx], fwd, pres, verify=verify,
        device=device)))


def compare(setup: Setup, win: "Window", want: Dict[int, list],
            lists: Optional[Dict[int, list]] = None) -> Dict[str, int]:
    """The numbers that decide `correct`: read instances checked (every
    replay of a read in `want`), those whose merged list differs from
    `want`'s, reads handed in that were never answered, and answers for
    reads that were not in flight. `lists` (by set index) stands in for
    the program's lists, as the control does."""
    n = len(setup.reads.reads)
    checked = mismatched = 0
    for tag, pairs in win.driver.lists().items():
        s = tag % n
        if s not in want:
            continue
        checked += 1
        mismatched += (pairs if lists is None else lists[s]) != want[s]
    done = np.asarray(win.driver.done_at, dtype=np.float64)
    return {"checked_reads": checked, "mismatched_reads": mismatched,
            "unanswered_reads": int(np.isnan(done).sum()),
            "stray_answers": int(win.driver.stray)}


# ------------------------------------------------------------------- run

LIMITS = {"mismatched_reads": 0, "unanswered_reads": 0, "stray_answers": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             cfg=None) -> Tuple[dict, List[str]]:
    """One run: (the result line's object, the check's lines)."""
    cache_dirs(cell.root)
    setup = Setup(cell, seed, device, t_start, cfg)
    if setup.build_s is not None:
        log(f"index_build_s {setup.build_s} (not in setup_s)")
    log(f"set-up {setup.setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in setup.steps.items())
        + f"), {len(setup.reads.reads)} reads in the set")
    n = len(setup.reads.reads)
    sample = sample_of(setup)
    win = Window(setup, seconds, trace, keep=lambda t: (t % n) in sample,
                 trace_path=os.path.join(cell.cache_dir, "trace.json"))
    ctx = context(setup, win)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    lat = (ctx.done_at - ctx.hand_at) * 1e3
    lat = lat[~np.isnan(lat)]
    q = (np.percentile(lat, [50, 90, 95, 99]).tolist() if len(lat)
         else [float("nan")] * 4)
    log(f"window {seconds} s: {ctx.reads} reads handed in "
        f"{len(win.batches)} batches, "
        f"{int((ctx.done_at <= ctx.deadline).sum())} finished by its end, "
        f"the last {float(np.nanmax(ctx.done_at)) - ctx.t0:.3f} s after "
        f"its start; per-read ms p50 {q[0]} p90 {q[1]} p95 {q[2]} "
        f"p99 {q[3]} over {len(lat)}; host redo {ctx.redone} reads in "
        f"{ctx.redo_s:.3f} s; {win.driver.__class__.__name__} calls "
        f"{ctx.call_s:.3f} s; launches {win.launches}; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
        f" GiB; hand-offs at "
        + ", ".join(f"{t - ctx.t0:.3f}" for _, _, t in win.batches))
    if win.analysis is not None:
        log("trace: host spans (s) " + json.dumps(
            win.analysis["host_spans"]) + f"; busy {win.analysis['busy_s']}")
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                   device))}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    out = {"correct": False, "attempted": ctx.reads,
           "failed": 0, "metrics": metrics, "device": dev}
    if trace and win.analysis is not None:
        dev["busy_s"] = win.analysis["busy_s"]
        dev["window_s"] = win.analysis["window_s"]
        out["breakdown"] = {"device_ops": win.analysis["device_ops"],
                            "idle_gaps": win.analysis["idle_gaps"]}
    redone = redone_of(setup, win)
    # free the program's state before the reference runs
    setup.searcher.close()
    setup.searcher = setup.index = win.driver.searcher = None
    win.driver.pool = None
    win.driver.pools = []
    win.work = None
    del ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    want = reference_lists(setup, sorted(sample | redone), device)
    nums = compare(setup, win, want)
    log(f"checked {nums['checked_reads']} read instances "
        f"({len(sample)} sampled reads, {len(redone)} redone) in "
        f"{time.perf_counter() - t_check:.3f} s")
    out["failed"] = nums["unanswered_reads"]
    out["correct"] = bool(nums["checked_reads"] > 0 and all(
        nums[k] <= lim for k, lim in LIMITS.items()))
    out["checks"] = {k: {"value": nums[k], "limit": lim}
                     for k, lim in LIMITS.items()}
    lines = [f"check {k} {nums[k]} limit {lim}"
             for k, lim in LIMITS.items()] + [f"correct {out['correct']}"]
    return out, lines
