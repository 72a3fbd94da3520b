"""The control of `correct` and the program's readings, at a cell's own
size, several seeds in one process.

    python3 -m perfbench.control --workload CELL --seeds S1,S2,... \\
        [--seconds 5] [--fault NAME] [--out FILE]

For each seed: the cell's reads from the seed, one window of --seconds at
the cell's own load (the set-up once: one searcher serves every seed),
drained; then the numbers that decide `correct` twice over the same read
instances:

- ``program``: the program's merged lists against the plain reference
  (the lower readings: a sound run reads 0 on each);
- ``control``: the plain reference computed with its text verification
  left out (reference.py, verify=False: a string longer than 14 counts as
  present when each of its 14-mers is), put in the program's place (the
  upper readings: it has to fail).

With ``--fault`` the program runs with that fault planted
(`perfbench/faults.py`), from set-up on, so its readings are the
fault's. Prints one JSON
line a seed and, last, a line with the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from . import faults, harness
from .spec import load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None, choices=sorted(faults.FAULTS),
                   help="run the program with this fault planted")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    root = os.getcwd()
    device = torch.device("cuda", 0)
    cell = load_cell(root, args.workload)
    harness.cache_dirs(root)
    seeds = [int(s) for s in args.seeds.split(",")]
    # planted before set-up: the searcher binds its host engine when made
    with (faults.planted(args.fault) if args.fault
          else contextlib.nullcontext()):
        setup = harness.Setup(cell, seeds[0], device, t_start)
        rows = readings(cell, setup, seeds, args.seconds, device)
    summary = {"workload": args.workload, "fault": args.fault,
               "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in harness.LIMITS},
               "control_min": {k: min(r["control"][k] for r in rows)
                               for k in harness.LIMITS},
               "device": torch.cuda.get_device_name(device)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


def readings(cell, setup, seeds, seconds, device):
    """One row of readings a seed."""
    rows = []
    for seed in seeds:
        setup.reseed(seed)
        n = len(setup.reads.reads)
        sample = harness.sample_of(setup)
        win = harness.Window(setup, seconds, False,
                             keep=lambda t: (t % n) in sample,
                             trace_path=os.path.join(cell.cache_dir,
                                                     "trace.json"))
        redone = harness.redone_of(setup, win)
        idx = sorted(sample | redone)
        want = harness.reference_lists(setup, idx, device)
        ctl = harness.reference_lists(setup, idx, device, verify=False)
        ctx = harness.context(setup, win)
        row = {"seed": seed, "reads": ctx.reads, "redone": ctx.redone,
               "metrics": {m.name: m.read(ctx) for m in cell.end_to_end},
               "program": harness.compare(setup, win, want),
               "control": harness.compare(setup, win, want, lists=ctl),
               "control_reads_differing": sum(ctl[i] != want[i]
                                              for i in idx),
               "reads_compared": len(idx)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del win, ctx
    return rows


if __name__ == "__main__":
    sys.exit(main())
