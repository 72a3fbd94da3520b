"""The wide engine on a repeat-rich genome, in parked-phase waves, on the
card.

    python -m svdss_tpu_torch.tools.repeat_wide [--fwd-mbp 1200]
        [--cmax 65534] [--reads 2048] [--device cuda]
        [--workdir build/giant/repeat_wide] [--out REPORT.json]

The port's counterpart of the JAX repo's tools/repeat_validation.py, on its
genome (build_repeat_genome, rng 4242: satellite, LINE-like and SINE-like
families over unique sequence) and reads (rng 7, 0.2% substitutions).
Uniform random text puts almost no k-mer over cmax; this one does, so the
wide engine parks lanes on heavy k-mers and the host answers those phases
from the tables' heavy store between waves (ops/anchor_wide.py
make_heavy_resolver). Stages, cached in --workdir:

  genome   the forward text and the generator's state after it
           (genome.npy, genome_rng.json): the phase sample draws on
  tables   wide host tables at --cmax (tables/)
  oracle   the wide host oracle with the resolver on the first reads, in
           --workers processes beside the device stage (oracle/)
  device   build_device_anchor_wide, then the reads in --batches
           interleaved WideWaveRuns (kernel K5, WideWaveScheduler), warm
           and timed; the host redo of the reads they flag; K5 once on its
           own, one shot on the first batch, timed by CUDA events
           (device.json)

Reports the heavy-phase rate, waves, resolved phases, the fallback rate
and reads/s with and without the redo, and holds the first --verify
device-resolved reads against the oracle. From 600 Mbp forward (1.2G
two-strand symbols) `run` takes these tables by size (cli._wide_anchor).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import common as C
from ..ops import anchor_wide_device as aw
from ..ops.anchor_wide import (build_anchor_index_wide, make_heavy_resolver,
                               rc_key_scalar)
from ..ops.pingpong import PingPongResult
from ..utils.device import resolve_device

MODULE = "svdss_tpu_torch.tools.repeat_wide"


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fwd-mbp", type=int, default=1200)
    ap.add_argument("--cmax", type=int, default=65534)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--sample-phases", type=int, default=200_000)
    ap.add_argument("--verify", type=int, default=64)
    ap.add_argument("--batches", type=int, default=2,
                    help="interleaved in-flight WideWaveRuns")
    ap.add_argument("--workers", type=int, default=4,
                    help="oracle processes beside the device stage")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default="build/giant/repeat_wide")
    ap.add_argument("--out", default=None,
                    help="report path (default WORKDIR/report.json)")
    ap.add_argument("--oracle-only", default=None, metavar="A:B",
                    help="worker mode: the oracle on reads [A, B)")
    return ap.parse_args(argv)


def schemes(args):
    genome = {"scheme": "build_repeat_genome", "seed": 4242,
              "fwd_mbp": args.fwd_mbp}
    tables = dict(genome, cmax=args.cmax)
    reads = dict(tables, reads="snv_reads(genome, rng 7)",
                 n_reads=args.reads, read_len=args.read_len)
    return genome, tables, reads


def make_reads(args, text):
    return C.snv_reads(text, args.reads, args.read_len, insertions=False)


def worker(args, wd: C.Workdir) -> int:
    g_s, t_s, _ = schemes(args)
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


def worker_argv(args) -> List[str]:
    return ["--fwd-mbp", str(args.fwd_mbp), "--cmax", str(args.cmax),
            "--reads", str(args.reads), "--read-len", str(args.read_len),
            "--workdir", args.workdir]


def phase_sample(widx, text, rng, n_sample: int, cmax: int) -> dict:
    """The JAX tool's heavy-phase sample: two-strand counts of the k-mers
    at uniform positions (its rng, continued after the genome)."""
    n = len(text)
    ps = rng.integers(0, n - widx.k, n_sample)
    keys = np.zeros(n_sample, dtype=np.int64)
    ok = np.ones(n_sample, dtype=bool)
    for i in range(widx.k):
        sym = text[ps + i].astype(np.int64)
        ok &= (sym >= 1) & (sym <= 4)
        keys = (keys << 2) | np.clip(sym - 1, 0, 3)
    keys = keys[ok]
    cnt_f = widx.cnts[keys].astype(np.int64)
    rck = np.array([rc_key_scalar(int(kk), widx.k) for kk in
                    keys[:50_000]], dtype=np.int64)
    two = cnt_f[:len(rck)] + widx.cnts[rck].astype(np.int64)
    return {"phase_heavy_rate": float(np.mean(two > cmax)),
            "phase_cnt_mean": float(np.mean(two)),
            "phase_cnt_p99": int(np.percentile(two, 99))}


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
        "tool": "repeat_wide", "fwd_mbp": args.fwd_mbp, "cmax": args.cmax,
        "reads": args.reads, "read_len": args.read_len,
        "batches": args.batches, "host": C.host_info(wd.root),
        **C.card_info(dev)})
    rep.flush()

    rng = np.random.default_rng(4242)
    if wd.ready("genome.npy"):
        text = np.load(wd.path("genome.npy"))
        with open(wd.path("genome_rng.json")) as f:
            rng.bit_generator.state = json.load(f)
    else:
        with C.stage(rep, "genome", log):
            text = C.build_repeat_genome(rng, args.fwd_mbp * 1_000_000,
                                         log=log)
            np.save(wd.path("genome.npy"), text)
            with open(wd.path("genome_rng.json"), "w") as f:
                json.dump(rng.bit_generator.state, f)
            wd.stamp("genome.npy")
    rep["two_strand_symbols"] = 2 * (len(text) + 1)
    rep["wide_by_size"] = rep["two_strand_symbols"] >= C.WIDE_BY_SIZE
    if wd.ready("tables", t_s):
        widx = C.load_wide(wd.path("tables"), text)
    else:
        with C.stage(rep, "tables", log):
            widx = build_anchor_index_wide(
                text, cmax=args.cmax, log=lambda m: log(f"[tables] {m}"))
        with C.stage(rep, "tables_save", log):
            C.save_wide(wd.path("tables"), widx)
            wd.stamp("tables", t_s)
    heavy = int(np.sum(widx.cnts[widx.aux == 0xFFFFFFFF] > 0)) \
        if len(widx.poslist) else 0
    rep.update(k=widx.k, j0=widx.j0, poslist_entries=int(len(widx.poslist)),
               heavy_kmer_slots=heavy, heavy_rate=widx.heavy_rate,
               **phase_sample(widx, text, rng, args.sample_phases,
                              args.cmax))
    rep.flush()
    reads, lens = make_reads(args, text)

    n_pre = min(args.reads, args.verify + args.verify // 2 + 16)
    dump = C.oracle_beside(
        wd, r_s, MODULE, worker_argv(args), range(n_pre), args.workers,
        lambda: device_stage(args, widx, reads, lens, dev, rep, log))
    flagged = np.flatnonzero(dump["bad"]).tolist()
    checked, mism, _ = C.hold_against_oracle(
        wd, dump["lists"], flagged, C.wide_oracle(widx, reads,
                                                  args.read_len),
        args.verify)
    rep.update(oracle_checked=checked, mismatches=mism,
               ok=mism == 0 and checked >= min(args.verify,
                                               args.reads - len(flagged)))
    rep.flush()
    log(json.dumps({k: rep[k] for k in ("resolve_waves", "mismatches",
                                        "oracle_checked", "ok")}))
    return rep


def device_stage(args, widx, reads, lens, dev, rep, log) -> dict:
    L = args.read_len
    with C.stage(rep, "upload", log):
        didx, params = aw.build_device_anchor_wide(widx, dev)
        C.sync(dev)
    rep["stages"]["upload"]["tables_gib"] = didx.nbytes / 2 ** 30
    rep.flush()
    resolver = make_heavy_resolver(widx)
    if resolver is None:
        raise RuntimeError("the tables lack the heavy store")
    nb = max(1, args.batches)
    Qb = args.reads // nb
    if Qb * nb != args.reads:
        raise ValueError("--batches must divide --reads")
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    cap = max(512, (L + 1) // 16)
    stats = {"waves": 0, "phases": 0, "host_s": 0.0}

    def make_resolve(base):
        def resolve_phases(lns, ancs, dirbs):
            th = time.time()
            stats["waves"] += 1
            stats["phases"] += len(lns)
            mm = np.empty(len(lns), dtype=np.int32)
            for j, (ln, a, d) in enumerate(zip(lns, ancs, dirbs)):
                mm[j] = resolver(reads[base + ln, :L], int(a),
                                 "left" if d == 1 else "right")
            stats["host_s"] += time.time() - th
            return mm
        return resolve_phases

    def run():
        runs = [aw.WideWaveRun(didx, params, seqs[b * Qb:(b + 1) * Qb],
                               lens_t[b * Qb:(b + 1) * Qb],
                               make_resolve(b * Qb), cap=cap)
                for b in range(nb)]
        parts = aw.WideWaveScheduler(runs).finish_all()
        return PingPongResult(*(torch.cat([getattr(p, f) for p in parts])
                                for f in PingPongResult._fields[:5]),
                              iters=sum(int(p.iters) for p in parts))

    t0 = time.time()
    run()
    C.sync(dev)
    rep["warm_s"] = time.time() - t0
    stats.update(waves=0, phases=0, host_s=0.0)
    l0 = aw.launches
    t0 = time.time()
    res = run()
    lists, bad = C.result_lists(res)
    t_dev = time.time() - t0
    rep.update(launches=aw.launches - l0, resolve_waves=stats["waves"],
               resolved_phases=stats["phases"],
               host_resolve_s=stats["host_s"], device_search_s=t_dev,
               fallback_reads=int(bad.sum()),
               fallback_rate=float(bad.mean()))
    fn = C.wide_oracle(widx, reads, L)
    t0 = time.time()
    redo_none = sum(fn(i) is None for i in np.nonzero(bad)[0])
    t_redo = time.time() - t0
    rep.update(host_redo_s=t_redo, host_redo_fallbacks=redo_none,
               reads_per_s_device=args.reads / t_dev,
               reads_per_s_incl_redo=args.reads / (t_dev + t_redo))
    rep.flush()
    log(f"[device] {rep['reads_per_s_device']:.1f} reads/s, "
        f"{stats['waves']} waves, {stats['phases']} phases, "
        f"{int(bad.sum())} fallbacks")
    rep["k5"], one_lists, one_bad = C.k5_oneshot(
        didx, params, seqs[:Qb], lens_t[:Qb], cap, dev)
    rep.flush()
    return {"lists": [C.jsonable(g) for g in lists],
            "bad": bad.astype(int).tolist(), "cap": cap,
            "oneshot_lists": one_lists,
            "oneshot_bad": one_bad.astype(int).tolist()}


if __name__ == "__main__":
    rep = main()
    sys.exit(0 if rep.get("ok", True) else 1)
