"""Multi-process scaling of the search stage: the JAX repo's
tools/scaling_bench.py.

    python -m svdss_tpu_torch.tools.scaling_bench [--reads 600]
        [--read-len 2500] [--procs 1,2] [--threads 1] [--no-device]
        [--device cuda|cpu] [--workdir build/scaling_bench]

The same read workload goes through ``python -m svdss_tpu_torch.cli
search`` at each process count P: P processes joined under
SVDSS_TPU_COORDINATOR / SVDSS_TPU_NUM_PROCS / SVDSS_TPU_PROC_ID
(parallel/distributed.py), each taking the ordinal-modulo shard of the
read stream, process 0 merging the SFS files. The stage time is the
slowest process's ``search: N reads in Xs`` line (without interpreter and
card start-up); efficiency at P is stage(1) / (P x stage(P)), and the merged
outputs of every P must hold the same SFSs (else exit 1).

The workload is the JAX tool's: seed 23, a genome of max(200 kb,
40 x --read-len), 4 insertions and 4 deletions of 60-200 bp on one
haplotype, reads at the coverage that gives about --reads, its FMD index,
all made with the port's copies of the JAX package's simulator, FASTA
writer and FMD index construction, into --workdir.

By default each process runs the device path on the card,
``cuda:(pid % cards)`` as the CLI picks it (on one card the processes
share it); --no-device runs the exact host engines (the JAX record's path,
docs/VALIDATION.md), --device cpu the kernels' plain versions (in batches
of 256 lanes). Each P runs once to warm up, then once measured.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from . import common as C
from ..utils.device import resolve_device

# the command each process runs (a wrapper may stand in for it)
CLI = [sys.executable, "-m", "svdss_tpu_torch.cli"]
_STAGE_RE = re.compile(r"search: (\d+) reads in ([0-9.]+)s")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_workload(wd: str, n_reads: int, read_len: int) -> dict:
    """scaling_bench.py's workload in wd: ref.fa, reads.bam, idx.npz."""
    from ..index.fmd import build_index
    from ..io.fasta import write_fasta
    from ..utils.simulate import (make_haplotype, random_genome,
                                  simulate_reads, write_bam)
    rng = np.random.default_rng(23)
    glen = max(200_000, read_len * 40)
    chroms = random_genome(rng, {"chrS": glen})
    h1 = make_haplotype(rng, "chrS", chroms["chrS"], n_ins=4, n_del=4,
                        min_len=60, max_len=200)
    h2 = make_haplotype(rng, "chrS", chroms["chrS"], n_ins=0, n_del=0)
    coverage = max(1, (n_reads * read_len) // (2 * glen))
    recs = simulate_reads(rng, [h1, h2], coverage=coverage,
                          read_len=read_len)
    os.makedirs(wd, exist_ok=True)
    ref, bam, idx = (os.path.join(wd, x)
                     for x in ("ref.fa", "reads.bam", "idx.npz"))
    write_fasta(ref, chroms)
    write_bam(bam, chroms, recs)
    build_index(chroms).save(idx)
    return {"ref": ref, "bam": bam, "idx": idx, "n_reads": len(recs)}


def run_procs(work: dict, wd: str, nprocs: int, path_args: List[str],
              threads: int) -> Tuple[float, float, str]:
    """One P-process run: (wall seconds, the slowest process's search
    stage seconds, the merged SFS file)."""
    out = os.path.join(wd, f"sfs_p{nprocs}.txt")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = C.PKG_PARENT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.time()
    procs = []
    for pid in range(nprocs):
        # --threads bounds each process's torch threads too (the plain
        # versions' loops), so P processes use P x threads cores
        env_p = {**env, "OMP_NUM_THREADS": str(threads),
                 "SVDSS_TPU_COORDINATOR": f"127.0.0.1:{port}",
                 "SVDSS_TPU_NUM_PROCS": str(nprocs),
                 "SVDSS_TPU_PROC_ID": str(pid)}
        cmd = [*CLI, "search", "--index", work["idx"], "--bam", work["bam"],
               "--out", out, "--threads", str(threads), *path_args]
        procs.append(subprocess.Popen(cmd, cwd=C.PKG_PARENT, env=env_p,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    stage, missing, failed = 0.0, [], []
    for pid, p in enumerate(procs):
        _, err = p.communicate(timeout=1800)
        err = err.decode()
        if p.returncode != 0:
            failed.append(f"proc {pid} failed:\n{err[-2000:]}")
            continue
        m = _STAGE_RE.search(err)
        if m:
            stage = max(stage, float(m.group(2)))
        else:
            missing.append(pid)
    if failed:
        raise RuntimeError("\n".join(failed))
    wall = time.time() - t0
    if stage == 0.0:
        print(f"[scaling] WARNING: no stage line from procs {missing}; "
              f"using wall time", file=sys.stderr)
        stage = wall
    return wall, stage, out


def canon(path: str) -> list:
    """An SFS file's lines with each read's name carried onto its
    continuation lines, sorted: equal for every process count."""
    with open(path) as fh:
        name, lines = None, []
        for ln in fh:
            f = ln.split("\t")
            name = f[0] if f[0] != "*" else name
            lines.append((name,) + tuple(f[1:]))
    return sorted(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=600)
    ap.add_argument("--read-len", type=int, default=2500)
    ap.add_argument("--procs", default="1,2")
    ap.add_argument("--threads", type=int, default=1,
                    help="host threads per process (1, so P processes use "
                         "P cores)")
    ap.add_argument("--no-device", action="store_true",
                    help="the exact host engines in each process")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default="build/scaling_bench")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    plist = [int(x) for x in args.procs.split(",")]
    # the plain versions on the CPU cost in proportion to a batch's lanes:
    # there the CLI's smallest batches (256 lanes; the output does not
    # depend on the batch)
    path_args = ["--no-device"] if args.no_device else (
        ["--device", "cpu", "--lanes", "64"] if dev.type == "cpu" else [])
    # the host path's times are host numbers; the plain versions' are not
    # the card's
    host_clock = args.no_device or dev.type == "cuda"
    work = make_workload(args.workdir, args.reads, args.read_len)
    print(f"[scaling] workload: {work['n_reads']} reads x "
          f"{args.read_len}bp", file=sys.stderr)
    results, stages, outs = {}, {}, {}
    for p in plist:
        run_procs(work, args.workdir, p, path_args, args.threads)   # warm
        results[p], stages[p], outs[p] = run_procs(
            work, args.workdir, p, path_args, args.threads)
        print(f"[scaling] P={p}: wall {results[p]:.1f}s, search stage "
              f"{stages[p]:.2f}s ({work['n_reads'] / max(stages[p], 1e-9):.1f}"
              f" reads/s)", file=sys.stderr)
    base_out = canon(outs[plist[0]])
    merged_equal = all(canon(outs[p]) == base_out for p in plist[1:])
    base = stages[plist[0]] * plist[0]
    report = {"metric": "search_multiprocess_scaling",
              "n_reads": work["n_reads"], "read_len": args.read_len,
              "threads_per_proc": args.threads,
              "path": "host" if args.no_device else "device",
              "merged_outputs_identical": merged_equal,
              "sfs_lines": len(base_out)}
    for name, value in (
            ("wall_s", {str(p): t for p, t in results.items()}),
            ("stage_s", {str(p): t for p, t in stages.items()}),
            ("reads_per_s", {str(p): work["n_reads"] / stages[p]
                             for p in plist}),
            ("efficiency", {str(p): base / (p * stages[p]) for p in plist})):
        report.update({name: value} if host_clock
                      else C.device_number(dev, name, value))
    report["device"] = C.card_info(dev)
    print(json.dumps(report), flush=True)
    return 0 if merged_equal else 1


if __name__ == "__main__":
    sys.exit(main())
