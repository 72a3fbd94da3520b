"""The wide anchor engine at GRCh38 scale, on the card.

    python -m svdss_tpu_torch.tools.giant_wide [--chrom-mbp 194]
        [--n-chrom 16] [--reads 8192] [--cmax 44] [--device cuda]
        [--workdir build/giant/giant_wide] [--out REPORT.json]

The port's counterpart of the JAX repo's tools/giant_wide.py, on the same
genome (16 x 194 Mbp forward of chrom_nt6 with seeds 1000 + i: 3,104,000,015
forward symbols, 6.2G two-strand) and reads (8,192 x 10 kb of chromosome 1,
rng 7). Stages, each cached in --workdir under a scheme stamp:

  genome   the forward text (genome.npy)
  tables   wide host tables (ops/anchor_wide.py build_anchor_index_wide,
           right-order-only buckets past 2e9 symbols as the JAX tool
           builds them; tables/)
  oracle   the wide host oracle (anchor_search_wide with the heavy-k-mer
           resolver) on the first reads, in --workers processes started
           with --oracle-only A:B beside the device stage (oracle/)
  device   pipeline/search.py's _DeviceSearcher over the tables, as `run`
           would take it (engine choice by wide_engine_cost, upload by
           build_device_anchor_wide, kernel K5 in parked-phase waves, host
           redo of the reads it flags), in read chunks of each --qs; then
           K5 once on its own, one shot on the first chunk, timed by CUDA
           events with its work counts (device.json)

Every device-resolved read the oracle answered is held against it; the
run fails on a mismatch or on fewer than --verify such reads. The redo
engine is the wide host oracle: the tool builds no FMD index of the
6.2G-symbol genome. At small sizes the engine gate of the search stage
takes FM below 2^26 symbols: pass --engine anchor there.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from typing import List, Optional

import numpy as np
import torch

from . import common as C
from ..config import Config
from ..ops import anchor_wide_device as aw
from ..ops.anchor_wide import (anchor_search_wide, build_anchor_index_wide,
                               make_heavy_resolver)
from ..pipeline.search import _DeviceSearcher, wide_engine_cost
from ..utils.device import resolve_device

MODULE = "svdss_tpu_torch.tools.giant_wide"
ONESHOT_CAP = 512     # K5's own launch: the JAX tool's emission cap


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chrom-mbp", type=int, default=194)
    ap.add_argument("--n-chrom", type=int, default=16)
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--cmax", type=int, default=44)
    ap.add_argument("--sort", choices=("auto", "full", "right"),
                    default="auto",
                    help="bucket order: right-order-only past 2e9 forward "
                         "symbols and full below (auto, the JAX tool's "
                         "rule), or either at any size")
    ap.add_argument("--qs", default="2048,4096,8192",
                    help="read chunks handed to the searcher, one pass over "
                         "the reads each")
    ap.add_argument("--verify", type=int, default=1152,
                    help="device-resolved reads to hold against the oracle")
    ap.add_argument("--workers", type=int, default=4,
                    help="oracle processes beside the device stage")
    ap.add_argument("--engine", choices=("auto", "anchor"), default="auto",
                    help="the search stage's engine choice (auto: as `run` "
                         "takes it; anchor below 2^26 symbols)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default="build/giant/giant_wide")
    ap.add_argument("--out", default=None,
                    help="report path (default WORKDIR/report.json)")
    ap.add_argument("--oracle-only", default=None, metavar="A:B",
                    help="worker mode: the oracle on reads [A, B)")
    return ap.parse_args(argv)


def schemes(args):
    genome = {"scheme": "chrom_nt6-per-chrom", "seeds": "1000+i",
              "chrom_mbp": args.chrom_mbp, "n_chrom": args.n_chrom}
    tables = dict(genome, cmax=args.cmax, sort=sort_mode(args))
    reads = dict(tables, reads="snv_reads(chr1, rng 7, insertions)",
                 n_reads=args.reads, read_len=args.read_len)
    return genome, tables, reads


def sort_mode(args) -> str:
    if args.sort != "auto":
        return args.sort
    n = args.n_chrom * (args.chrom_mbp * 1_000_000 + 1) - 1
    return "right" if n > 2_000_000_000 else "full"


def make_reads(args, text: np.ndarray):
    return C.snv_reads(text[:args.chrom_mbp * 1_000_000], args.reads,
                       args.read_len)


def worker(args, wd: C.Workdir) -> int:
    """--oracle-only A:B: the oracle on reads [A, B) from the cached genome
    and tables (mapped read-only, shared with the other workers)."""
    g_s, t_s, r_s = schemes(args)
    if not (wd.ready("genome.npy", g_s) and wd.ready("tables", t_s)):
        raise RuntimeError("oracle workers need the cached genome and "
                           "tables")
    text = np.load(wd.path("genome.npy"), mmap_mode="r")
    widx = C.load_wide(wd.path("tables"), text)
    reads, _ = make_reads(args, text)
    a, b = (int(x) for x in args.oracle_only.split(":"))
    C.oracle_lines(wd.path("oracle"), a, b, range(a, min(b, args.reads)),
                   C.wide_oracle(widx, reads, args.read_len))
    return 0


def main(argv: Optional[List[str]] = None, log=print) -> dict:
    args = parse(argv)
    g_s, t_s, r_s = schemes(args)
    wd = C.Workdir(args.workdir, g_s)
    if args.oracle_only:
        worker(args, wd)
        return {}
    dev = resolve_device(args.device)
    C.need_native()
    rep = C.Report(args.out or wd.path("report.json"), {
        "tool": "giant_wide", "chrom_mbp": args.chrom_mbp,
        "n_chrom": args.n_chrom, "cmax": args.cmax,
        "sort": sort_mode(args), "reads": args.reads,
        "read_len": args.read_len, "host": C.host_info(wd.root),
        **C.card_info(dev)})
    rep.flush()

    if wd.ready("genome.npy"):
        text = np.load(wd.path("genome.npy"))
    else:
        with C.stage(rep, "genome", log):
            text = C.forward_genome(args.chrom_mbp, args.n_chrom)
            np.save(wd.path("genome.npy"), text)
            wd.stamp("genome.npy")
    rep["n_fwd_symbols"] = len(text)
    rep["two_strand_symbols"] = 2 * len(text)
    if wd.ready("tables", t_s):
        widx = C.load_wide(wd.path("tables"), text)
    else:
        with C.stage(rep, "tables", log):
            sort = sort_mode(args)
            widx = build_anchor_index_wide(
                text, cmax=args.cmax,
                sort_buckets="right" if sort == "right" else True,
                log=lambda m: log(f"[tables] {m}"))
        with C.stage(rep, "tables_save", log):
            C.save_wide(wd.path("tables"), widx)
            wd.stamp("tables", t_s)
    rep.update(k=widx.k, j0=widx.j0, poslist_entries=int(len(widx.poslist)),
               heavy_rate=widx.heavy_rate,
               heavy_kmers=int(len(widx.heavy_keys))
               if widx.heavy_keys is not None else 0)
    reads, lens = make_reads(args, text)
    L = args.read_len

    # the oracle beside the device stage: the first reads, with room for
    # the device's fallbacks
    n_pre = min(args.reads, args.verify + args.verify // 8 + 64)
    t_oracle = time.time()
    dump = C.oracle_beside(
        wd, r_s, MODULE, worker_argv(args), range(n_pre), args.workers,
        lambda: device_stage(args, widx, reads, lens, dev, rep, log))
    with C.stage(rep, "oracle", log):
        checked, mism, oracle_fb = C.hold_against_oracle(
            wd, dump["lists"], dump["redone"],
            C.wide_oracle(widx, reads, L), args.verify)
    resolved = args.reads - len(dump["redone"])
    rep.update(oracle_verified_reads=checked, mismatches=mism,
               oracle_fallback_on_device_resolved=oracle_fb,
               oracle_wall_s=time.time() - t_oracle,
               device_resolved_reads=resolved,
               ok=mism == 0 and checked + oracle_fb >= min(args.verify,
                                                           resolved))
    rep.flush()
    log(json.dumps({k: rep[k] for k in ("mismatches", "oracle_verified_reads",
                                        "device_resolved_reads", "ok")}))
    return rep


def worker_argv(args) -> List[str]:
    return ["--chrom-mbp", str(args.chrom_mbp), "--n-chrom",
            str(args.n_chrom), "--reads", str(args.reads), "--read-len",
            str(args.read_len), "--cmax", str(args.cmax), "--sort",
            sort_mode(args), "--workdir", args.workdir]


def device_stage(args, widx, reads, lens, dev, rep, log) -> dict:
    """The searcher's passes and K5's own launch; returns the device dump
    (per-read lists of the first pass, the reads it redid on the host, and
    K5's one-shot lists and flags)."""
    L = args.read_len
    encoded = [reads[i, :L].copy() for i in range(args.reads)]
    config = Config(engine=args.engine)
    # the search stage sees the two-strand FMD index's size; the redo
    # engine is the wide oracle, with the heavy resolver (no FMD index is
    # built at this size)
    n2 = 2 * (args.n_chrom * (args.chrom_mbp * 1_000_000 + 1))
    stand_in = types.SimpleNamespace(n=n2)
    agpp, fgpp, depth = wide_engine_cost(widx)
    rep["engine_cost"] = {"anchor_gathers_per_phase": agpp,
                          "fm_gathers_per_phase": fgpp, "pw_depth": depth}
    with C.stage(rep, "upload", log):
        searcher = _DeviceSearcher(stand_in, config, dev, anchor=widx)
        C.sync(dev)
    rep["engine"] = ("wide anchor, parked-phase waves"
                     if searcher.wide and searcher.heavy_resolver
                     else "wide anchor, one shot" if searcher.wide
                     else "anchor" if searcher.anchor is not None else "fm")
    rep["stages"]["upload"]["tables_gib"] = searcher.anchor.nbytes / 2 ** 30 \
        if searcher.wide else None
    rep.flush()
    if not searcher.wide:
        raise RuntimeError(f"the search stage took the {rep['engine']} "
                           f"engine, not the wide anchor engine")
    resolver = make_heavy_resolver(widx)

    def redo(_index, batch, overlap, _threads):
        return [anchor_search_wide(widx, r, overlap, resolver)
                for r in batch]
    searcher.host_search = redo
    first = None
    rep["configs"] = []
    try:
        # a warm-up batch (the kernels' build and first launch) outside the
        # timed passes
        t0 = time.time()
        searcher.search_batch(encoded[:min(args.reads, 256)])
        rep["warm_s"] = time.time() - t0
        for Q in [int(q) for q in args.qs.split(",") if q]:
            Q = min(Q, args.reads)
            cfg = {"Q": Q, "device_s": 0.0, "redo_s": 0.0, "waves": 0,
                   "parked_phases": 0, "fallback_reads": 0}
            l0 = aw.launches
            lists, redone = [], []
            for base in range(0, args.reads, Q):
                chunk = encoded[base:base + Q]
                t0 = time.time()
                handle = searcher.dispatch(chunk)
                run = handle[1]
                out, deferred = searcher.collect(handle, defer_redo=True)
                cfg["device_s"] += time.time() - t0
                cfg["waves"] += getattr(run, "n_waves", 0)
                cfg["parked_phases"] += getattr(run, "parked_lanes", 0)
                if deferred is not None:
                    t0 = time.time()
                    idx, fut = deferred
                    for i, r in zip(idx, fut.result()):
                        out[i] = r
                    cfg["redo_s"] += time.time() - t0
                    redone += [base + i for i in idx]
                lists += out
            cfg.update(launches=aw.launches - l0, fallback_reads=len(redone),
                       reads_per_s_device=args.reads / cfg["device_s"],
                       reads_per_s_with_redo=args.reads
                       / (cfg["device_s"] + cfg["redo_s"]))
            if first is None:
                first = (lists, redone)
            else:
                cfg["cross_mismatch"] = sum(
                    a != b for a, b in zip(first[0], lists))
            rep["configs"].append(cfg)
            rep.flush()
            log(f"[device] Q={Q}: {cfg['reads_per_s_device']:.1f} reads/s, "
                f"{cfg['launches']} launches, {cfg['waves']} waves, "
                f"{len(redone)} redone")
        Q = rep["configs"][0]["Q"]
        seqs = torch.from_numpy(reads[:Q]).to(dev)
        lens_t = torch.from_numpy(lens[:Q]).to(dev)
        k5, one_lists, one_bad = C.k5_oneshot(
            searcher.anchor, searcher.anchor_params, seqs, lens_t,
            ONESHOT_CAP, dev)
    finally:
        searcher.close()
    rep["k5"] = k5
    rep.flush()
    return {"lists": [C.jsonable(g) for g in first[0]],
            "redone": first[1], "oneshot_cap": ONESHOT_CAP,
            "oneshot_lists": one_lists,
            "oneshot_bad": one_bad.astype(int).tolist()}


if __name__ == "__main__":
    rep = main()
    sys.exit(0 if rep.get("ok", True) else 1)
