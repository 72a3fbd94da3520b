"""Per-lane finish-round distribution of the one-shot anchor kernel (K3):
the JAX repo's tools/lane_hist.py.

    python -m svdss_tpu_torch.tools.lane_hist [--genome-bp 100000000]
        [--reads 4096] [--read-len 10000] [--cap 512] [--cmax 16]
        [--smoke] [--device cuda|cpu] [--workdir build/bench]

A one-shot launch ends with its slowest lane: its time goes with
max(done_r) rounds while the useful work is mean(done_r) lane rounds.
utilization = mean / max is the share of the launch's lane rounds that do
work; 1 / utilization is what a refilled pool (K4) could recover at most.
On the H100 the kernel runs a warp per read, so a finished warp frees its
slot for the next block; the distribution still says how far the slowest
read sets the launch.

K3 runs once with per-lane stop rounds (batch_search_anchor(...,
debug_hist=True)) at the JAX tool's settings: cap 512, no round cap, over
tools/bench.py's workload and anchor tables (cmax 16, cached under
--workdir). It prints the JAX tool's lines, then the rounds of the lanes
that would pass the search stage's round cap (tools/bench.py round_cap:
714 at 10 kb) and go to the host, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import bench
from . import common as C
from ..ops.anchor_device import batch_search_anchor, build_device_anchor
from ..utils.device import resolve_device

ACTIVE_FRACS = (0.9, 0.5, 0.25, 0.1, 0.05, 0.01)


def finish_rounds(done_r: np.ndarray, iters: int) -> np.ndarray:
    """Each lane's last round, a lane that never stopped at the launch's
    rounds (the JAX tools' rule)."""
    d = np.asarray(done_r).astype(np.int64)
    return np.where(d < 0, iters, d)


def hist(done_r: np.ndarray, iters: int) -> dict:
    """lane_hist.py's numbers of one launch's stop rounds."""
    d2 = finish_rounds(done_r, iters)
    q = np.percentile(d2, [50, 90, 99, 100])
    util = float(d2.mean()) / iters
    return {"iters": iters, "mean": float(d2.mean()), "p50": float(q[0]),
            "p90": float(q[1]), "p99": float(q[2]), "max": float(q[3]),
            "utilization": util, "ideal_refill_speedup": 1 / util,
            "lanes_hit_budget": int((np.asarray(done_r) < 0).sum()),
            "active_after": {f"{frac:.2f}": float(
                np.percentile(d2, 100 * (1 - frac))) for frac in ACTIVE_FRACS}}


def hist_lines(h: dict) -> List[str]:
    """The JAX tool's lines after its first (which holds the time)."""
    lines = [f"[lane-hist] finish round: mean {h['mean']:.0f}  "
             f"p50 {h['p50']:.0f}  p90 {h['p90']:.0f}  p99 {h['p99']:.0f}  "
             f"max {h['max']:.0f}",
             f"[lane-hist] utilization {h['utilization']:.3f} -> ideal "
             f"refill speedup {h['ideal_refill_speedup']:.2f}x  "
             f"({h['lanes_hit_budget']} lanes hit budget)"]
    for frac in ACTIVE_FRACS:
        lines.append(f"  {frac:4.0%} of lanes still active after round "
                     f"{h['active_after'][f'{frac:.2f}']:.0f}")
    return lines


def run_hist(didx, params, reads, lens, cap: int, dev
             ) -> Tuple[object, np.ndarray, float]:
    """K3 once with stop rounds: (result, done_r, seconds to results on
    the host)."""
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    t0 = time.time()
    res, done_r = batch_search_anchor(didx, params, seqs, lens_t, cap=cap,
                                      debug_hist=True)
    d = done_r.cpu().numpy()
    return res, d, time.time() - t0


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=100_000_000)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--cap", type=int, default=512)
    ap.add_argument("--cmax", type=int, default=16)
    ap.add_argument("--smoke", action="store_true",
                    help="tools/bench.py's --smoke shape: 1 Mbp, 256 x 2 kb")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default="build/bench",
                    help="tools/bench.py's anchor-table cache")
    args = ap.parse_args(argv)
    if args.smoke:
        args.genome_bp, args.reads, args.read_len = 1_000_000, 256, 2_000
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    dev = resolve_device(args.device)
    genome = bench.make_genome(args.genome_bp)
    reads, lens = bench.make_reads(genome, args.reads, args.read_len)
    aidx = bench.build_anchor(genome, args.genome_bp, args.cmax,
                              workdir=args.workdir)
    didx, params = build_device_anchor(aidx, dev)
    run_hist(didx, params, reads[:1], lens[:1], args.cap, dev)   # warm
    res, d, secs = run_hist(didx, params, reads, lens, args.cap, dev)
    h = hist(d, int(res.iters))
    tag = "" if dev.type == "cuda" else " (cpu)"
    print(f"[lane-hist] run {secs:.1f}s{tag}, iters={h['iters']}",
          flush=True)
    for line in hist_lines(h):
        print(line)
    rc = bench.round_cap(args.read_len)
    d2 = finish_rounds(d, h["iters"])
    over = np.sort(d2[d2 > rc])
    print(f"[lane-hist] {len(over)} lanes past the search stage's round cap "
          f"{rc}: rounds {over.tolist()}", flush=True)
    out = {"tool": "lane_hist", "genome_bp": args.genome_bp,
           "reads": args.reads, "read_len": args.read_len, "cap": args.cap,
           "cmax": args.cmax, **h,
           "sfs": int(res.n_sfs.sum()),
           "flagged": int((res.overflow | res.incomplete).sum()),
           "round_cap": rc, "past_round_cap": len(over),
           "past_round_cap_rounds": over.tolist()}
    out.update(C.device_number(dev, "run_s", secs))
    out["device"] = C.card_info(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
