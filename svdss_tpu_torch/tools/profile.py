"""Device-time breakdown of one search call on the card: the JAX repo's
tools/profile_search.py and tools/profile_anchor.py.

    python -m svdss_tpu_torch.tools.profile [--target fm|anchor|wide|pool|
        search] [--genome-bp 100000000] [--reads 4096] [--read-len 10000]
        [--jump-k K] [--max-iters 4800] [--smoke] [--run-workdir DIR]
        [--engine auto|anchor|fm] [--threads N] [--device cuda|cpu]
        [--workdir build/bench]

Targets (the workload is tools/bench.py's, byte for byte, its caches under
--workdir):

  fm      kernel K2 (ops/pingpong.py batch_search) on --reads x --read-len
          at cap 512 and profile_search.py's --max-iters 4800 (0: the
          full search); with --jump-k the k-mer table is built inside the
          call by kernel K6 (ops/fmd.py build_jump_table)
  anchor  kernel K3 (ops/anchor_device.py batch_search_anchor) at cap 512
          over profile_anchor.py's tables (cmax 16), no round cap
  wide    kernel K5 one shot (ops/anchor_wide_device.py) over wide tables
          of the whole genome (profile_anchor.py's "wide"; cached as
          WORKDIR/anchorw_GENOME_BP.npz), cap 512
  pool    kernel K4 (ops/anchor_pool.py AnchorPool, 8,192 lanes) over
          tools/bench.py's pool stream (the batch 4 times), the host redo
          of its flagged reads included
  search  pipeline/search.py run_search as ``cli run`` calls it (the same
          Config, anchor tables and smoothed BAM) on the artifacts of a
          ``run`` work directory (--run-workdir: index.fmd.npz, its anchor
          tables, smoothed.bam), with --engine; its SFS file goes to
          --workdir and is compared with the run's specifics.txt

Method: one warm call (for ``search`` only the kernels' load on the card:
each call lays out and uploads its own device tables, as in ``cli run``),
then
torch.profiler with CPU and CUDA activities over one call that ends in
torch.cuda.synchronize(), under the label ``profile:TARGET``; the Chrome
trace goes to WORKDIR/profile_TARGET.json. A one-element op runs first
inside the profiler, outside the label, so that the profiler's buffer
set-up at its first CUDA call (~4 ms on the H100) falls before the
window. The tool labels its own calls with record_function; the
program's host steps (the pool's pack, launch, wait, fetch and lists, the
host redo, the table layout and upload, the search stage's batches) carry
their own spans (svdss_tpu_torch/trace.py), which open record_function
while the profiler records.

Report (stdout; the JSON line last):

- the JAX tools' listing: device time by kernel name and by the host op
  that launched it (memcpy and memset included), as a share of device
  time, top 60 down to 0.5%, with K1-K6 named from the ``__global__``
  names of csrc/;
- the window (the label's interval in the trace, and the host clock),
  device busy time (the union of kernel, memcpy and memset intervals in
  the window) and busy share;
- the 10 longest idle gaps of the window, each with the innermost host
  event open at its middle: a label, an aten op, a CUDA API call or the
  profiler's own work, or "python" where none is.

A run on the CPU (``--device cpu``, the kernels' plain versions) has no
device timeline: the call runs once under the labels, unprofiled (a trace
of the plain versions' aten ops says nothing of the card), and the line
reports "not measured" for the trace and every device number, and the
host seconds under cpu_ names. If the trace holds no device event of
the target's kernels, the busy share is "not measured" and the window is
timed by CUDA events instead, under a name that says so.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, record_function

from . import bench
from . import common as C
from ..utils.device import load_kernels, resolve_device

NOT_MEASURED = C.NOT_MEASURED
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("user_annotation", "cpu_op")
API_CATS = ("cuda_runtime", "cuda_driver")
# the profiler's own host work (Kineto's "Activity Buffer Request")
OVERHEAD_CATS = ("overhead",)
TOP, FLOOR, GAPS = 60, 0.005, 10
# the kernels' __global__ names in csrc/ -> the port's kernel names
GLOBALS = {"wavefront_reg_kernel": "K1", "wavefront_scratch_kernel": "K1",
           "pingpong_fm_kernel": "K2", "anchor_batch_kernel": "K3",
           "anchor_pool_kernel": "K4", "anchor_wide_kernel": "K5",
           "jump_level_kernel": "K6"}
# each kernel's launch counter (a module-level `launches`)
COUNTERS = {"K1": "svdss_tpu_torch.ops.align_dp",
            "K2": "svdss_tpu_torch.ops.pingpong",
            "K3": "svdss_tpu_torch.ops.anchor_device",
            "K4": "svdss_tpu_torch.ops.anchor_pool",
            "K5": "svdss_tpu_torch.ops.anchor_wide_device",
            "K6": "svdss_tpu_torch.ops.fmd"}
TARGETS = ("fm", "anchor", "wide", "pool", "search")


def log(msg: str) -> None:
    print(f"[profile] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------ trace arithmetic

def kernel_label(name: str) -> Optional[str]:
    """K1-K6 for a device event named after one of csrc/'s kernels."""
    for g, k in GLOBALS.items():
        if g in name:
            return k
    return None


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Sorted, merged [start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(merged: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in merged if b > lo and a < hi]


def busy(merged: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> float:
    """The time in [lo, hi) covered by the merged intervals."""
    return sum(b - a for a, b in clip(merged, lo, hi))


def idle_gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The uncovered stretches of [lo, hi), longest first."""
    gaps, t = [], lo
    for a, b in clip(merged, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


class Intervals:
    """Host events, for the question: which is the innermost (shortest)
    one open at time t (its start <= t < its end)?"""

    def __init__(self, events: Sequence[dict]):
        self.events = list(events)
        self.ts = np.array([e["ts"] for e in self.events], dtype=np.float64)
        self.dur = np.array([e["dur"] for e in self.events],
                            dtype=np.float64)

    def innermost(self, t: float) -> Optional[dict]:
        open_ = (self.ts <= t) & (t < self.ts + self.dur)
        if not open_.any():
            return None
        return self.events[int(np.argmin(np.where(open_, self.dur,
                                                  np.inf)))]


def host_name(e: Optional[dict]) -> str:
    return "python" if e is None else e["name"]


def split(events: Sequence[dict]) -> Tuple[list, list, list, list]:
    """The trace's complete events as (device, host ops and labels, CUDA
    API calls, the profiler's own work)."""
    full = [e for e in events if e.get("ph") == "X" and "dur" in e]
    return tuple([e for e in full if e.get("cat") in cats]
                 for cats in (DEVICE_CATS, HOST_OP_CATS, API_CATS,
                              OVERHEAD_CATS))


def launching_op(e: dict, api_by_corr: Dict[int, dict],
                 host: Intervals) -> str:
    """The host op or label open when the API call that queued device
    event `e` started (matched by correlation id)."""
    api = api_by_corr.get((e.get("args") or {}).get("correlation"))
    if api is None:
        return "(launch not in trace)"
    return host_name(host.innermost(api["ts"]))


def listing(dev: Sequence[dict], key) -> List[dict]:
    """Device time grouped by key(event), as a share of all device time:
    the largest TOP groups down to FLOOR."""
    total = sum(e["dur"] for e in dev) or 1.0
    groups: Dict[str, List[float]] = {}
    for e in dev:
        g = groups.setdefault(key(e), [0.0, 0])
        g[0] += e["dur"]
        g[1] += 1
    rows = []
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        if len(rows) >= TOP or us / total < FLOOR:
            break
        rows.append({"name": name, "kernel": kernel_label(name),
                     "ms": us / 1e3, "count": n, "share": us / total})
    return rows


def analyse(events: Sequence[dict], label: str) -> dict:
    """Busy share, listings and idle gaps of the window of the host label
    `label` in a Chrome trace's events (times in µs)."""
    dev, host, api, overhead = split(events)
    win = [e for e in host if e["name"] == label]
    if not win:
        raise RuntimeError(f"the trace holds no {label!r} event")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in dev if e["ts"] + e["dur"] > lo and e["ts"] < hi]
    merged = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    api_by_corr = {(e.get("args") or {}).get("correlation"): e for e in api}
    ops, everything = Intervals(host), Intervals(host + api + overhead)
    kernels: Dict[str, int] = {}
    for e in dev:
        k = kernel_label(e["name"])
        if k:
            kernels[k] = kernels.get(k, 0) + 1
    gaps = []
    for a, b in idle_gaps(merged, lo, hi)[:GAPS]:
        e = everything.innermost((a + b) / 2)
        gaps.append({"at_ms": (a - lo) / 1e3, "ms": (b - a) / 1e3,
                     "host": host_name(e),
                     "host_cat": None if e is None else e["cat"]})
    b = busy(merged, lo, hi)
    own = union((e["ts"], e["ts"] + e["dur"]) for e in overhead)
    return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": b / 1e3,
            "busy_share": b / (hi - lo) if hi > lo else 0.0,
            "device_events": len(dev), "kernels_in_trace": kernels,
            "api_events": len(api),
            "profiler_overhead_ms": busy(own, lo, hi) / 1e3,
            "by_kernel": listing(dev, lambda e: e["name"]),
            "by_op": listing(dev, lambda e: launching_op(e, api_by_corr,
                                                         ops)),
            "idle_gaps": gaps}


# --------------------------------------------------------------- targets

def to_dev(reads, lens, dev):
    with record_function("upload reads"):
        return (torch.from_numpy(reads).to(dev),
                torch.from_numpy(lens).to(dev))


def target_call(args, dev: torch.device) -> Tuple[object, dict]:
    """Build what --target needs and return (call, what), `call` one run
    of the profiled work with its results on the host."""
    if args.target == "search":
        return search_call(args, dev)
    what = {"genome_bp": args.genome_bp}
    genome = bench.make_genome(args.genome_bp)
    reads, lens = bench.make_reads(genome, args.reads, args.read_len)
    what["shape"] = f"Q={args.reads} L={args.read_len} cap=512"
    if args.target == "fm":
        from ..ops.fmd import DeviceFMDIndex, build_jump_table
        from ..ops.pingpong import batch_search
        index, _ = bench.build_problem(args.genome_bp, args.reads,
                                       args.read_len, workdir=args.workdir)
        dev_index = DeviceFMDIndex.from_host(index, dev)
        seqs, lens_t = to_dev(reads, lens, dev)
        what.update(max_iters=args.max_iters, jump_k=args.jump_k)

        def call():
            jump = {}
            if args.jump_k:
                with record_function("K6 build_jump_table"):
                    jump = dict(jump_k=args.jump_k, jump_table=(
                        build_jump_table(dev_index, args.jump_k)))
            with record_function("K2 batch_search"):
                res = batch_search(dev_index, seqs, lens_t, cap=512,
                                   max_iters=args.max_iters, **jump)
            return fetch(res)
        return call, what
    if args.target == "wide":
        from ..ops.anchor_wide import (AnchorIndexWide,
                                       build_anchor_index_wide)
        from ..ops.anchor_wide_device import (batch_search_anchor_wide,
                                              build_device_anchor_wide)
        cache = os.path.join(args.workdir, f"anchorw_{args.genome_bp}.npz")
        if os.path.exists(cache):
            widx = AnchorIndexWide.load(cache)
        else:
            t0 = time.time()
            widx = build_anchor_index_wide(bench.genome_nt6(genome))
            log(f"wide tables built in {time.time() - t0:.1f}s")
            os.makedirs(args.workdir, exist_ok=True)
            widx.save(cache)
        didx, params = build_device_anchor_wide(widx, dev)
        what["tables_gib"] = didx.nbytes / 2 ** 30
        seqs, lens_t = to_dev(reads, lens, dev)

        def call():
            with record_function("K5 batch_search_anchor_wide"):
                res = batch_search_anchor_wide(didx, params, seqs, lens_t,
                                               cap=512)
            return fetch(res)
        return call, what
    from ..ops.anchor_device import batch_search_anchor, build_device_anchor
    aidx = bench.build_anchor(genome, args.genome_bp, workdir=args.workdir)
    didx, params = build_device_anchor(aidx, dev)
    what["tables_gib"] = didx.nbytes / 2 ** 30
    if args.target == "anchor":
        seqs, lens_t = to_dev(reads, lens, dev)

        def call():
            with record_function("K3 batch_search_anchor"):
                res = batch_search_anchor(didx, params, seqs, lens_t,
                                          cap=512)
            return fetch(res)
        return call, what
    index, _ = bench.build_problem(args.genome_bp, args.reads, args.read_len,
                                   workdir=args.workdir)
    enc = bench.pool_stream(reads, lens)
    what["shape"] = f"{len(enc)} reads x {args.read_len}, 8192 lanes, cap 512"

    def call():
        with record_function("K4 pool pass"):
            _, redo, rounds, launches, n_sfs = bench.pool_pass(
                didx, params, index, enc)
        return {"host_redo": redo, "rounds_run": rounds,
                "pool_launches": launches, "sfs": n_sfs}
    return call, what


def fetch(res) -> dict:
    with record_function("fetch n_sfs"):
        n = res.n_sfs.cpu()
    return {"sfs": int(n.sum()), "iters": int(res.iters),
            "flagged": int((res.overflow | res.incomplete).sum())}


def search_call(args, dev: torch.device) -> Tuple[object, dict]:
    """run_search as cmd_run calls it, on --run-workdir's artifacts."""
    from .. import cli
    from ..index.fmd import FMDIndex
    from ..pipeline.search import run_search
    if not args.run_workdir:
        raise SystemExit("--target search needs --run-workdir")
    rw = args.run_workdir
    index_path = os.path.join(rw, "index.fmd.npz")
    smoothed = os.path.join(rw, "smoothed.bam")
    # the plain versions on the CPU cost in proportion to a batch's lanes:
    # there the CLI's smallest batches (256 lanes; the output does not
    # depend on the batch)
    cargs = cli.build_parser().parse_args(
        ["run", "--reference", os.path.join(rw, "ref.fa"), "--bam", smoothed,
         "--workdir", rw, "--engine", args.engine,
         "--threads", str(args.threads)]
        + (["--lanes", "64"] if dev.type == "cpu" else []))
    cfg = cli._cfg(cargs)
    index = FMDIndex.load(index_path)
    anchor = cli._load_anchor(cfg, index_path)
    out = os.path.join(args.workdir, f"profile_search_{args.engine}.txt")
    os.makedirs(args.workdir, exist_ok=True)
    what = {"run_workdir": rw, "engine": args.engine, "symbols": index.n,
            "anchor_tables": None if anchor is None
            else type(anchor).__name__}

    def call():
        with open(out, "w") as fh:
            groups = run_search(cfg, index, bam=smoothed, out=fh,
                                device=dev, anchor=anchor)
        ref = os.path.join(rw, "specifics.txt")
        got = {"reads_with_sfs": len(groups)}
        if os.path.exists(ref):
            got["specifics_identical"] = (open(out, "rb").read()
                                          == open(ref, "rb").read())
        return got
    return call, what


# ------------------------------------------------------------------ main

def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", choices=TARGETS, default="fm")
    ap.add_argument("--genome-bp", type=int, default=100_000_000)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--jump-k", dest="jump_k", type=int, default=0,
                    help="fm: build the k-mer table (K6) in the call")
    ap.add_argument("--max-iters", type=int, default=4800,
                    help="fm: K2's step budget (profile_search.py's 4800; "
                         "0: 8 L + 64, the whole search)")
    ap.add_argument("--smoke", action="store_true",
                    help="tools/bench.py's --smoke shape: 1 Mbp, 256 x 2 kb")
    ap.add_argument("--run-workdir", default=None,
                    help="search: a `cli run` work directory")
    ap.add_argument("--engine", choices=("auto", "anchor", "fm"),
                    default="auto", help="search: the engine choice")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 4,
                    help="search: host threads, as `cli run --threads`")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default="build/bench",
                    help="tools/bench.py's caches, the trace, the SFS file")
    args = ap.parse_args(argv)
    if args.smoke:
        args.genome_bp, args.reads, args.read_len = 1_000_000, 256, 2_000
    return args


def launches() -> Dict[str, int]:
    return {k: importlib.import_module(m).launches
            for k, m in COUNTERS.items()}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    call, what = target_call(args, dev)
    label = f"profile:{args.target}"
    t0 = time.time()
    if args.target != "search":
        call()
    elif on_card:
        load_kernels()
    C.sync(dev)
    warm_s = time.time() - t0
    # on the CPU there is no device timeline: the call runs unprofiled
    prof = torch.profiler.profile(activities=[
        ProfilerActivity.CPU, ProfilerActivity.CUDA]) if on_card \
        else contextlib.nullcontext()
    before = launches()
    with prof:
        if on_card:
            # the profiler takes its activity buffers at the first CUDA
            # call it sees (~4 ms): before the window, not in it
            torch.ones(1, device=dev).add_(1)
            C.sync(dev)
        t0 = time.perf_counter()
        with record_function(label):
            result = call()
            C.sync(dev)
        host_s = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in launches().items()
                if n > before[k]}
    out = {"tool": "profile", "target": args.target, **what,
           "result": result, "launches": launched}
    out.update(C.device_number(dev, "warm_s", warm_s))
    out.update(C.device_number(dev, "window_host_s", host_s))
    if on_card:
        trace = os.path.join(args.workdir, f"profile_{args.target}.json")
        os.makedirs(args.workdir, exist_ok=True)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        out.update(trace=trace, trace_bytes=os.path.getsize(trace),
                   trace_events=len(events))
        rep = analyse(events, label)
        out.update(rep)
        missing = [k for k in sorted(launched)
                   if k not in rep["kernels_in_trace"]]
        if missing:
            # CUPTI gave no activity for these kernels: no busy share
            out["busy_share"] = out["device_busy_ms"] = NOT_MEASURED
            out["kernels_missing_from_trace"] = missing
            out["window_ms_cuda_events"] = C.event_ms(call, 1)
    else:
        out.update({k: NOT_MEASURED for k in (
            "trace", "window_ms", "device_busy_ms", "busy_share",
            "by_kernel", "by_op", "idle_gaps")})
    out["device"] = C.card_info(dev)
    print_listing(out)
    print(json.dumps(out), flush=True)
    return 0


def fmt(x, spec: str) -> str:
    return x if isinstance(x, str) else format(x, spec)


def print_listing(out: dict) -> None:
    if not isinstance(out.get("by_kernel"), list):
        print(f"[profile] {out['target']}: no device timeline "
              f"({out['device']['device']})")
        return
    for title in ("by_kernel", "by_op"):
        print(f"[profile] device time {title.replace('_', ' ')}:")
        for r in out[title]:
            print(f"{r['share'] * 100:6.2f}%  {r['ms']:10.4f} ms  "
                  f"{r['kernel'] or '':2}  {r['name'][:110]}")
    print(f"[profile] window {out['window_ms']:.3f} ms, device busy "
          f"{fmt(out['device_busy_ms'], '.3f')} ms, busy share "
          f"{fmt(out['busy_share'], '.4f')}")
    for g in out["idle_gaps"]:
        print(f"[profile] idle {g['ms']:10.4f} ms at +{g['at_ms']:.3f} ms: "
              f"{g['host']}")


if __name__ == "__main__":
    sys.exit(main())
