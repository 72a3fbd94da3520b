"""The FM kernel's (K2) cost a step with every lane live, and its step
count: the JAX repo's tools/step_cost.py.

    python -m svdss_tpu_torch.tools.step_cost [--genome-bp 100000000]
        [--reads 4096] [--read-len 10000] [--smoke] [--device cuda|cpu]
        [--workdir build/bench]

K2 (ops/pingpong.py batch_search, cap 512) on tools/bench.py's workload at
max_iters 960 and 1,920, where every lane of the batch is still searching:
the difference of the two times over the difference of their steps is the
marginal cost of a step with all lanes live. Then the whole search
(max_iters 0: 8 L + 64), whose ``iters`` is the slowest lane's steps. Each
time is the mean of 3 launches by CUDA events after a warm-up (the JAX tool
took one host-clock window; the card needs no host transfer to sync).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from . import bench
from . import common as C
from ..ops.fmd import DeviceFMDIndex
from ..ops.pingpong import batch_search
from ..utils.device import resolve_device

BUDGETS = (960, 1920, 0)      # the JAX tool's two budgets, then the whole


def step_iters(dev_index, seqs, lens, max_iters: int) -> int:
    """K2's `iters` under a step budget (0: the whole search)."""
    return int(batch_search(dev_index, seqs, lens, cap=512,
                            max_iters=max_iters).iters)


def step_ms(dev_index, seqs, lens, max_iters: int, dev) -> float:
    """ms of one launch: CUDA events (mean of 3 after a warm-up) on the
    card, the host clock of one call on the CPU."""
    fn = lambda: batch_search(dev_index, seqs, lens, cap=512,  # noqa: E731
                              max_iters=max_iters)
    if dev.type == "cuda":
        return C.event_ms(fn, 3)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=100_000_000)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--smoke", action="store_true",
                    help="tools/bench.py's --smoke shape: 1 Mbp, 256 x 2 kb")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default="build/bench",
                    help="tools/bench.py's index cache")
    args = ap.parse_args(argv)
    if args.smoke:
        args.genome_bp, args.reads, args.read_len = 1_000_000, 256, 2_000
    dev = resolve_device(args.device)
    index, genome = bench.build_problem(args.genome_bp, args.reads,
                                        args.read_len, workdir=args.workdir)
    reads, lens = bench.make_reads(genome, args.reads, args.read_len)
    dev_index = DeviceFMDIndex.from_host(index, dev)
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    q, L = args.reads, args.read_len
    it = {b: step_iters(dev_index, seqs, lens_t, b) for b in BUDGETS}
    ms = {b: step_ms(dev_index, seqs, lens_t, b, dev) for b in BUDGETS}
    (i1, i2, itf), (t1, t2, tf) = it.values(), ms.values()
    marginal = (t2 - t1) / (i2 - i1) * 1e3 if i2 > i1 else None
    tag = "" if dev.type == "cuda" else " (cpu)"
    print(f"Q={q} L={L}: {i1} iters in {t1 / 1e3:.4f}s; {i2} iters in "
          f"{t2 / 1e3:.4f}s{tag}")
    if marginal is not None:
        print(f"marginal per-step: {marginal:.2f} us ({marginal / q * 1e3:.2f}"
              f" ns/lane){tag}")
    print(f"full run: {itf} iters in {tf / 1e3:.3f}s -> "
          f"{tf / itf * 1e3:.2f} us/step avg, {q / (tf / 1e3):.1f} reads/s"
          f"{tag}")
    out = {"tool": "step_cost", "genome_bp": args.genome_bp, "q": q, "L": L,
           "iters": {str(b or "full"): n for b, n in it.items()}}
    out.update(C.device_number(dev, "ms", {str(b or "full"): t
                                           for b, t in ms.items()}))
    for name, value in (
            ("marginal_us_per_step", marginal),
            ("marginal_ns_per_lane",
             None if marginal is None else marginal / q * 1e3),
            ("avg_us_per_step", tf / itf * 1e3),
            ("reads_per_s", q / (tf / 1e3))):
        out.update(C.device_number(dev, name, value))
    out["device"] = C.card_info(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
