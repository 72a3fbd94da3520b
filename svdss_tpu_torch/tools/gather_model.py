"""Cost model of a batched random row gather on the card: the JAX repo's
tools/gather_model.py.

    python -m svdss_tpu_torch.tools.gather_model [--grid all|jax|port]
        [--points ROWSxWIDTH,...] [--qs 4096,65536] [--device cuda|cpu]

The search kernels are gather-bound: each round of a lane reads table rows
at data-dependent addresses. This times the card's own gather,
``table[idx].sum()`` over int32 tables (a microbenchmark of the card, not a
port of a kernel), over

  * rows per gather (Q: 4,096 and 65,536),
  * row width (int32 words) and table size (rows),
  * random and sorted indices,

and prints ns/row for each point. The grids:

  jax   gather_model.py's ten (rows, width) points, tables and indices
        drawn from numpy's default_rng(0) in its order;
  port  the tables the port's kernels read, at their sizes: the narrow
        anchor tables of the 40 Mbp run (4.16 GiB as 16 B rows, and its
        80 MB text as 64 B rows) and the wide tables of 2.06, 8.83 and
        14.51 GiB (40 Mbp, repeat_wide, giant_wide) as 4 B words; built
        on the card from a seeded torch.Generator (the values do not change
        what is timed).

Timing: CUDA events around each gather; before each repeat a 256 MiB
buffer is written, so the 50 MB L2 holds none of the table (the JAX tool's
repeats: 20 at Q = 4,096, 5 at 65,536). Each point's sum is checked: a
numpy table's against numpy's, a card table's against index_select's. The
JAX tool's emission half (one-hot ``where`` against scatter) is left out:
it times XLA lowering choices, and the port's kernels write emissions
straight into their [Q, cap] rows.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import common as C
from ..utils.device import resolve_device

GIB = 2 ** 30
JAX_GRID = [(1_500_000, 48), (12_000_000, 48), (1_500_000, 2),
            (12_000_000, 2), (268_000_000, 2), (1_500_000, 32),
            (1_500_000, 8), (1_500_000, 128), (100_000, 48), (8_000, 48)]
# (name, table bytes, row width in int32 words)
PORT_TABLES = [("narrow small, 40 Mbp run", int(4.16 * GIB), 4),
               ("narrow text rows, 40 Mbp run", 80_000_064, 16),
               ("wide, 40 Mbp run", int(2.06 * GIB), 1),
               ("wide, repeat_wide", int(8.83 * GIB), 1),
               ("wide, giant_wide", int(14.51 * GIB), 1)]
FLUSH_BYTES = 256 * 2 ** 20
MODES = ("rand", "sort")


def reps_for(q: int) -> int:
    return 20 if q == 4096 else 5


def jax_points(grid: List[Tuple[int, int]], qs: List[int], seed: int = 0
               ) -> Iterator[Tuple[str, np.ndarray, list]]:
    """gather_model.py's draws, in its order: for each (rows, width) the
    table, then for each Q and mode the int32 indices (sorted for "sort").
    Yields (name, table, [(q, mode, indices)])."""
    rng = np.random.default_rng(seed)
    for n_rows, width in grid:
        table = rng.integers(0, 100, (n_rows, width), dtype=np.int32)
        idx = []
        for q in qs:
            for mode in MODES:
                ix = rng.integers(0, n_rows, q).astype(np.int32)
                if mode == "sort":
                    ix = np.sort(ix)
                idx.append((q, mode, ix))
        yield f"{n_rows}x{width}", table, idx


def gather_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The timed op: the rows at idx, summed (int64, so exact)."""
    return table[idx].sum()


def time_point(table: torch.Tensor, idx: torch.Tensor, reps: int,
               flush: Optional[torch.Tensor]) -> float:
    """Mean ms of one gather: CUDA events around each, the L2 flushed
    before each; on the CPU the host clock."""
    gather_sum(table, idx)                        # warm-up
    if table.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            gather_sum(table, idx)
        return (time.perf_counter() - t0) / reps * 1e3
    pairs = []
    for r in range(reps):
        flush.fill_(r)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        gather_sum(table, idx)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def measure(name: str, table: torch.Tensor, q: int, mode: str,
            idx: torch.Tensor, want: int, flush, dev) -> dict:
    reps = reps_for(q)
    got = int(gather_sum(table, idx))
    ms = time_point(table, idx, reps, flush)
    rows, width = table.shape
    rec = {"table": name, "rows": rows, "width": width,
           "table_bytes": table.numel() * 4, "q": q, "mode": mode,
           "reps": reps, "sum": got, "sum_ok": got == want}
    rec.update(C.device_number(dev, "ns_per_row", ms / q * 1e6))
    rec.update(C.device_number(dev, "ms", ms))
    tag = "" if dev.type == "cuda" else " (cpu)"
    print(f"rows={rows:>11} width={width:>3} q={q:>6} {mode}: "
          f"{ms / q * 1e6:7.1f} ns/row{tag}  ({ms:.2f} ms)"
          + ("" if rec["sum_ok"] else "  SUM MISMATCH"), flush=True)
    return rec


def run_jax_grid(grid, qs, dev, flush) -> List[dict]:
    out = []
    for name, table_np, idx in jax_points(grid, qs):
        table = torch.from_numpy(table_np).to(dev)
        for q, mode, ix in idx:
            want = int(table_np[ix].sum(dtype=np.int64))
            out.append(measure(name, table, q, mode,
                               torch.from_numpy(ix).long().to(dev), want,
                               flush, dev))
        del table
    return out


def run_port_tables(tables, qs, dev, flush, seed: int = 1) -> List[dict]:
    out = []
    g = torch.Generator(device=dev)
    for i, (name, nbytes, width) in enumerate(tables):
        g.manual_seed(seed + i)
        rows = nbytes // (4 * width)
        table = torch.randint(0, 100, (rows, width), dtype=torch.int32,
                              device=dev, generator=g)
        for q in qs:
            for mode in MODES:
                idx = torch.randint(0, rows, (q,), device=dev, generator=g)
                if mode == "sort":
                    idx = idx.sort().values
                want = int(table.index_select(0, idx).sum())
                out.append(measure(name, table, q, mode, idx, want, flush,
                                   dev))
        del table
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def parse_points(text: str) -> List[Tuple[int, int]]:
    return [tuple(int(v) for v in p.split("x")) for p in text.split(",")]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", choices=("all", "jax", "port"), default="all")
    ap.add_argument("--points", default=None,
                    help="ROWSxWIDTH,... in place of the JAX grid (its "
                         "draws, in its order)")
    ap.add_argument("--qs", default="4096,65536")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    qs = [int(q) for q in args.qs.split(",")]
    grid = parse_points(args.points) if args.points else JAX_GRID
    print(f"device: {C.card_info(dev)}", flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev) \
        if dev.type == "cuda" else None
    if flush is not None:
        # ~0.2 s of writes, so the first point does not meet idle clocks
        for r in range(2000):
            flush.fill_(r)
        torch.cuda.synchronize()
    points = []
    if args.grid in ("all", "jax"):
        points += run_jax_grid(grid, qs, dev, flush)
    if args.grid in ("all", "port"):
        points += run_port_tables(PORT_TABLES, qs, dev, flush)
    ok = all(p["sum_ok"] for p in points)
    print(json.dumps({"tool": "gather_model", "op": "table[idx].sum()",
                      "l2_flush_bytes": FLUSH_BYTES if flush is not None
                      else 0, "points": points, "sums_ok": ok,
                      "device": C.card_info(dev)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
