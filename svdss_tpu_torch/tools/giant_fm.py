"""The FM search's wide mode past 2^31 symbols, on the card.

    python -m svdss_tpu_torch.tools.giant_fm [--chrom-mbp 200] [--n-chrom 8]
        [--reads 1024] [--oracle 256] [--device cuda]
        [--workdir build/giant/giant_fm] [--out REPORT.json]

The port's counterpart of the JAX repo's tools/giant_validation.py and
tools/validate_wide.py, on giant_validation's genome (8 x 200 Mbp of
chrom_nt6 with seeds 1000 + i: 3,200,000,016 two-strand symbols) and reads
(1,024 x 10 kb of chromosome 1, rng 7). Stages, cached in --workdir:

  index    the two-strand FMD index (index/fmd.py build_index, the native
           grouped builder; index/)
  oracle   the scalar oracle (ops/pingpong_host.py ping_pong_search) on the
           first --oracle reads, in --workers processes started with
           --oracle-only A:B beside the device stage (oracle/)
  device   DeviceFMDIndex.from_host, wide by the index's size (2^31
           symbols or more; --force-wide below it), then kernel K2's wide
           instantiation through ops/pingpong.py batch_search on all reads
           in one launch, timed by CUDA events with its rank steps
           (device.json)

Every lane is held against the native host engine (ops/pingpong_native.py,
a flagged lane counting as a mismatch, as in the JAX tool), and the first
--oracle lanes also against the scalar oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import common as C
from ..index.fmd import build_index
from ..ops import pingpong
from ..ops.fmd import DeviceFMDIndex
from ..ops.pingpong_host import ping_pong_search
from ..ops.pingpong_native import open_native_fmd
from ..utils.device import resolve_device

MODULE = "svdss_tpu_torch.tools.giant_fm"
CAP = 512     # the JAX tools' emission cap


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chrom-mbp", type=int, default=200)
    ap.add_argument("--n-chrom", type=int, default=8)
    ap.add_argument("--reads", type=int, default=1024)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--oracle", type=int, default=256,
                    help="lanes also held against the scalar oracle")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 2,
                    help="index build threads")
    ap.add_argument("--workers", type=int, default=6,
                    help="scalar-oracle processes beside the device stage")
    ap.add_argument("--force-wide", action="store_true",
                    help="wide mode below 2^31 symbols (small checks)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default="build/giant/giant_fm")
    ap.add_argument("--out", default=None,
                    help="report path (default WORKDIR/report.json)")
    ap.add_argument("--oracle-only", default=None, metavar="A:B",
                    help="worker mode: the scalar oracle on reads [A, B)")
    return ap.parse_args(argv)


def schemes(args):
    genome = {"scheme": "chrom_nt6-per-chrom", "seeds": "1000+i",
              "chrom_mbp": args.chrom_mbp, "n_chrom": args.n_chrom}
    reads = dict(genome, reads="snv_reads(chr1, rng 7, insertions)",
                 n_reads=args.reads, read_len=args.read_len)
    return genome, reads


def chromosomes(args) -> dict:
    """giant_validation.py's genome: chrom_nt6(1000 + i) as ACGT strings."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return {f"chr{i + 1}": bases[C.chrom_nt6(
        1000 + i, args.chrom_mbp * 1_000_000) - 1].tobytes().decode()
        for i in range(args.n_chrom)}


def make_reads(args):
    return C.snv_reads(C.chrom_nt6(1000, args.chrom_mbp * 1_000_000),
                       args.reads, args.read_len)


def worker(args, wd: C.Workdir) -> int:
    """--oracle-only A:B: the scalar oracle on reads [A, B) over the cached
    index (mapped read-only)."""
    if not wd.ready("index"):
        raise RuntimeError("oracle workers need the cached index")
    index = C.load_fmd(wd.path("index"))
    reads, _ = make_reads(args)
    a, b = (int(x) for x in args.oracle_only.split(":"))
    L = args.read_len
    C.oracle_lines(wd.path("oracle"), a, b, range(a, min(b, args.reads)),
                   lambda i: ping_pong_search(index, reads[i, :L].copy()))
    return 0


def worker_argv(args) -> List[str]:
    return ["--chrom-mbp", str(args.chrom_mbp), "--n-chrom",
            str(args.n_chrom), "--reads", str(args.reads), "--read-len",
            str(args.read_len), "--workdir", args.workdir]


def main(argv: Optional[List[str]] = None, log=print) -> dict:
    args = parse(argv)
    g_s, r_s = schemes(args)
    wd = C.Workdir(args.workdir, g_s)
    if args.oracle_only:
        worker(args, wd)
        return {}
    dev = resolve_device(args.device)
    C.need_native()
    rep = C.Report(args.out or wd.path("report.json"), {
        "tool": "giant_fm", "chrom_mbp": args.chrom_mbp,
        "n_chrom": args.n_chrom, "reads": args.reads,
        "read_len": args.read_len, "threads": args.threads,
        "host": C.host_info(wd.root), **C.card_info(dev)})
    rep.flush()

    if wd.ready("index"):
        index = C.load_fmd(wd.path("index"), mmap=False)
    else:
        with C.stage(rep, "index", log):
            index = build_index(chromosomes(args), threads=args.threads)
        with C.stage(rep, "index_save", log):
            C.save_fmd(wd.path("index"), index)
            wd.stamp("index")
    rep["n_symbols"] = index.n
    rep.flush()
    reads, lens = make_reads(args)
    L = args.read_len
    encoded = [reads[i, :L].copy() for i in range(args.reads)]

    n_or = min(args.oracle, args.reads)
    with C.stage(rep, "host_engine", log):
        t0 = time.time()
        nf = open_native_fmd(index, threads=2)
        if nf is None:
            raise RuntimeError("the native host engine is not built "
                               "(make -C native)")
        rep["host_engine_open_s"] = time.time() - t0
        t0 = time.time()
        host = nf.search_batch(encoded, threads=2)
        rep["host_search_s"] = time.time() - t0
        rep["host_reads_per_s_2t"] = args.reads / rep["host_search_s"]
        nf.close()
    dump = C.oracle_beside(
        wd, r_s, MODULE, worker_argv(args), range(n_or), args.workers,
        lambda: device_stage(args, index, reads, lens, dev, rep, log))

    got = [[tuple(p) for p in g] for g in dump["lists"]]
    bad = dump["bad"]
    mism = sum(1 for i in range(args.reads)
               if bad[i] or got[i] != [tuple(p) for p in host[i]])
    want = C.read_oracle(wd.path("oracle"))
    or_mism = sum(1 for i in range(n_or)
                  if bad[i] or got[i] != want[i])
    rep.update(reads_checked=args.reads, mismatches=mism,
               device_flagged=int(sum(bad)), oracle_lanes=n_or,
               oracle_mismatches=or_mism,
               ok=mism == 0 and or_mism == 0 and dump["wide"])
    rep.flush()
    log(json.dumps({k: rep[k] for k in ("mismatches", "oracle_mismatches",
                                        "wide_by_size", "ok")}))
    return rep


def device_stage(args, index, reads, lens, dev, rep, log) -> dict:
    """The wide table's upload and K2's launch on every read; returns the
    per-lane lists and flags."""
    if not (args.force_wide or index.n >= 2 ** 31):
        raise RuntimeError(f"{index.n} symbols stay narrow: the wide mode "
                           f"is taken from 2^31 (--force-wide below it)")
    with C.stage(rep, "upload", log):
        di = DeviceFMDIndex.from_host(index, dev,
                                      force_wide=args.force_wide)
        C.sync(dev)
    rep.update(wide=di.wide, wide_by_size=di.wide and index.n >= 2 ** 31,
               limb_bits=di.limb_bits)
    rep["stages"]["upload"]["table_gib"] = di.nbytes / 2 ** 30
    rep.flush()
    seqs = torch.from_numpy(reads).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    work = torch.zeros(1, dtype=torch.int64, device=dev)
    l0 = pingpong.launches
    t0 = time.time()
    res = pingpong.batch_search(di, seqs, lens_t, cap=CAP, work=work)
    C.sync(dev)
    k2 = {"shape": f"Q={args.reads} L+1={args.read_len + 1} cap={CAP}",
          "launches": pingpong.launches - l0, "iters": int(res.iters),
          "rank_steps": int(work.item())}
    if dev.type == "cuda":
        k2["k2_ms"] = C.event_ms(lambda: pingpong.batch_search(
            di, seqs, lens_t, cap=CAP), 3)
        k2["us_per_step"] = k2["k2_ms"] * 1e3 / max(1, k2["iters"])
        k2["reads_per_s_device"] = args.reads / (k2["k2_ms"] / 1e3)
    else:
        k2["plain_s_cpu"] = time.time() - t0
    nbytes, ops = C.fm_bytes_ops(di, lens_t, k2["rank_steps"], res.n_sfs)
    k2["bound_bytes"] = nbytes
    k2["bound_ms"], k2["bound_by"] = C.bound_ms(nbytes, ops)
    rep["k2"] = k2
    rep.flush()
    log(f"[device] K2 wide={di.wide}: {k2}")
    lists, bad = C.result_lists(res)
    return {"lists": lists, "bad": bad.astype(int).tolist(),
            "wide": di.wide, "cap": CAP}


if __name__ == "__main__":
    rep = main()
    sys.exit(0 if rep.get("ok", True) else 1)
