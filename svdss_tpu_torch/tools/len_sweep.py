"""One-shot anchor kernel (K3) throughput against read length, over one
table upload: the JAX repo's tools/len_sweep.py.

    python -m svdss_tpu_torch.tools.len_sweep [--genome-bp 100000000]
        [--lens 2000,10000,30000] [--base-reads 4096] [--cap 512]
        [--cmax 16] [--iters 3] [--smoke] [--device cuda|cpu]
        [--workdir build/bench]

The anchor tables (tools/bench.py's, cmax 16, cached under --workdir) go
to the card once; then for each read length L a batch of Q = max(256,
base_reads x 10,000 / L) lanes, rounded down to a multiple of 256, so Q x L
stays near the 10 kb shape's, of tools/bench.py's reads. Each batch runs
once to warm up and then --iters times with per-lane stop rounds
(debug_hist), each a host-clock window that ends with the results on the
host; the median window gives reads/s. Per length: the finish-round
quantiles, utilization (mean / max), ns a lane round, the lanes flagged
for the host and the SFSs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import bench
from . import common as C
from .lane_hist import finish_rounds
from ..ops.anchor_device import batch_search_anchor, build_device_anchor
from ..utils.device import resolve_device


def lanes_for(base_reads: int, L: int) -> int:
    """len_sweep.py's Q: Q x L held near base_reads x 10 kb."""
    q = max(256, (base_reads * 10_000) // L)
    return (q // 256) * 256


def sweep_one(didx, params, genome, L: int, Q: int, cap: int, iters: int,
              dev) -> dict:
    reads, rlens = bench.make_reads(genome, Q, L)
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(rlens).to(dev)

    def once():
        t0 = time.time()
        res, done_r = batch_search_anchor(didx, params, seqs, lens_t,
                                          cap=cap, debug_hist=True)
        res.n_sfs.cpu()
        return res, done_r, time.time() - t0

    _, _, warm = once()
    times = []
    for _ in range(iters):
        res, done_r, dt = once()
        times.append(dt)
    t = float(np.median(times))
    rounds = int(res.iters)
    dr = finish_rounds(done_r.cpu().numpy(), rounds)
    rec = {"Q": Q, "total_rounds": rounds,
           "done_mean": float(dr.mean()),
           "done_p50": int(np.percentile(dr, 50)),
           "done_p90": int(np.percentile(dr, 90)),
           "done_p99": int(np.percentile(dr, 99)),
           "done_max": int(dr.max()),
           "util": float(dr.mean()) / max(1, rounds),
           "fallback": int((res.incomplete | res.overflow).sum()),
           "sfs": int(res.n_sfs.sum())}
    for name, value in (("reads_per_s", Q / t), ("t", t), ("warm_s", warm),
                        ("ns_per_lane_round", t / (Q * max(1, rounds)) * 1e9)):
        rec.update(C.device_number(dev, name, value))
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=100_000_000)
    ap.add_argument("--lens", default="2000,10000,30000")
    ap.add_argument("--base-reads", type=int, default=4096,
                    help="lane count at 10 kb; scaled inversely with L")
    ap.add_argument("--cap", type=int, default=512)
    ap.add_argument("--cmax", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="1 Mbp, 256 lanes at 10 kb, 1 iter")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default="build/bench",
                    help="tools/bench.py's anchor-table cache")
    args = ap.parse_args(argv)
    if args.smoke:
        args.genome_bp, args.base_reads, args.iters = 1_000_000, 256, 1
    dev = resolve_device(args.device)
    print(f"[sweep] device: {C.card_info(dev)}", flush=True)
    genome = bench.make_genome(args.genome_bp)
    aidx = bench.build_anchor(genome, args.genome_bp, args.cmax,
                              workdir=args.workdir)
    t0 = time.time()
    didx, params = build_device_anchor(aidx, dev)
    C.sync(dev)
    print(f"[sweep] tables up in {time.time() - t0:.1f}s "
          f"({didx.nbytes / 2 ** 30:.2f} GiB)", flush=True)
    report = {}
    for L in (int(x) for x in args.lens.split(",")):
        rec = sweep_one(didx, params, genome, L,
                        lanes_for(args.base_reads, L), args.cap, args.iters,
                        dev)
        report[str(L)] = rec
        print(f"[sweep] L={L}: {json.dumps(rec)}", flush=True)
    report["device"] = C.card_info(dev)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
