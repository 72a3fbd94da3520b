"""The whole pipeline on a seed-pinned diploid sample with planted SVs, from
one chromosome to a whole genome.

    python -m svdss_tpu_torch.tools.chr_scale [--genome-mbp 40]
        [--n-chrom 1] [--coverage 30] [--read-len 12000] [--n-sv 60]
        [--threads 2] [--engine auto|anchor|fm] [--seed 21]
        [--workdir build/chr_scale] [--device cuda | --no-device]
        [--keep] [--sim-only] [--check-host] [--out REPORT.json]

The port's counterpart of the JAX repo's tools/chr_scale.py, on its sample:
the same generators (utils/simulate.py) called in the same order from the
same seed, so ref.fa, truth.txt and the decompressed reads.bam equal that
tool's. The reads are simulated one chromosome at a time and written in
slices of records through the native parallel deflater, so the tool holds
one chromosome's records at most. Then ``python -m svdss_tpu_torch.cli
run`` (index -> anchor tables -> smooth -> search -> call) runs as a child
process, on --device (the card unless ``--device cpu``; ``--no-device``
runs the host engines); from 600 Mbp (1.2G two-strand symbols) its anchor
tables are the wide ones, picked by size. With --check-host, ``run
--no-device`` follows on hard links of the index and smoothed BAM, and its
specifics.txt and VCF must equal the device run's byte for byte.

Reports one JSON line (and --out, rewritten after every stage): the stage
seconds parsed from the run's log, the anchor tables' kind, the engine the
search took, its host redos, the child's peak resident memory, the work
directory's disk use, and recall, precision and F1 of the calls against the
planted SVs: a planted SV is recovered by a call of its SVTYPE on its
chromosome within 200 bp, and a call is true if it so matches any planted
SV (`score`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import common as C
from ..utils.device import resolve_device

# the child process that runs the pipeline; `run` and its options follow
CLI = [sys.executable, "-m", "svdss_tpu_torch.cli"]
# records a deflater call: bounds the encoded slice held at once
SLICE_RECORDS = 8192
# more of the run's log the report carries at its top level
RUN_KEYS = ("search_reads", "smooth_xf", "tables_gib",
            "anchor_build_peak_rss_gib")

# the run's log lines the report reads: the stage seconds (cli.py,
# pipeline/smooth.py, pipeline/search.py, pipeline/call.py), the anchor
# tables' build and the engine the search took
_LOG = {
    "index": re.compile(r"run: index built in ([\d.]+)s \((\d+) symbols\)"),
    "anchor_build": re.compile(
        r"index: (WIDE anchor|anchor) tables \(k=(\d+).*? built in "
        r"([\d.]+)s, peak RSS ([\d.]+) GiB"),
    "smooth": re.compile(
        r"smooth: (\d+) alignments in ([\d.]+)s .*XF0=(\d+) XF1=(\d+) "
        r"XF2=(\d+) XF3=(\d+) dropped=(\d+)"),
    "search": re.compile(r"search: (\d+) reads in ([\d.]+)s"
                         r"(?: \([\d.]+ reads/s\), (\d+) host fallbacks)?"),
    "call": re.compile(r"call: (\d+) SVs in ([\d.]+)s"),
    "engine": re.compile(r"search: (wide anchor|anchor|FM) engine on (\S+) "
                         r"\((.*)\)$"),
    "tables_gib": re.compile(r"tables ([\d.]+) GiB"),
    "pool": re.compile(r"search: anchor pool on"),
    "cost_model": re.compile(r"search: engine cost model picks FM — (.*)"),
}


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mbp", type=int, default=40)
    ap.add_argument("--n-chrom", type=int, default=1,
                    help="split the genome over this many chromosomes; "
                         "reads are simulated and written a chromosome at "
                         "a time")
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=12_000)
    ap.add_argument("--n-sv", type=int, default=60)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--engine", default=None,
                    choices=(None, "auto", "anchor", "fm"),
                    help="passed to the run's --engine")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--workdir", default="build/chr_scale")
    ap.add_argument("--device", default="cuda",
                    help="the run's --device: cuda (the default), cuda:N "
                         "or cpu (the kernels' plain versions)")
    ap.add_argument("--no-device", action="store_true",
                    help="run the host engines")
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir (default: wiped first for a "
                         "clean, non-resumed run)")
    ap.add_argument("--sim-only", action="store_true",
                    help="simulate and write the inputs, then exit")
    ap.add_argument("--check-host", action="store_true",
                    help="then run --no-device on hard links of the index "
                         "and smoothed BAM; ok needs equal outputs")
    ap.add_argument("--out", default=None,
                    help="report path (default WORKDIR/report.json)")
    return ap.parse_args(argv)


# ------------------------------------------------------------ simulation

def simulate(args, ref: str, bam: str, truth_f: str, log=print) -> int:
    """The JAX tool's sample (tools/chr_scale.py:79-108, call for call):
    the genome, then per chromosome two haplotypes and their reads, each
    chromosome's records written in slices of SLICE_RECORDS through the
    native deflater (the header first, every part without the BGZF EOF
    block, the EOF block last). Returns the number of reads."""
    from concurrent.futures import ThreadPoolExecutor
    from ..io.bam import BamHeader, _encode_record
    from ..io.fasta import write_fasta
    from ..io.native import bgzf_write_all
    from ..pipeline.smooth import _header_bytes
    from ..utils.simulate import (make_haplotype, random_genome,
                                  simulate_reads)
    import struct

    def deflate(data: bytes, flags: int) -> None:
        if not bgzf_write_all(bam, data, level=1,
                              n_threads=max(1, args.threads), flags=flags):
            raise RuntimeError(f"{bam}: the native deflater failed")

    rng = np.random.default_rng(args.seed)
    per = args.genome_mbp * 1_000_000 // args.n_chrom
    chroms = random_genome(rng, {f"chr{c + 1}": per
                                 for c in range(args.n_chrom)})
    write_fasta(ref, chroms)
    sv_per_hc = max(1, args.n_sv // (2 * args.n_chrom * 2))
    header = BamHeader.from_refs([(n, len(s)) for n, s in chroms.items()])
    deflate(_header_bytes(header), 2)
    n_reads = 0
    # one deflater call in flight beside the encoding of the next slice
    # (ctypes releases the GIL); appends stay in order
    with ThreadPoolExecutor(max_workers=1) as pool, \
            open(truth_f, "w") as fh:
        pending = None
        for tid, (cname, cseq) in enumerate(chroms.items()):
            haps = []
            for _ in range(2):
                h = make_haplotype(rng, cname, cseq, n_ins=sv_per_hc,
                                   n_del=sv_per_hc, min_len=50, max_len=400)
                haps.append(h)
                for sv in h.svs:
                    fh.write(f"{sv.type}\t{sv.pos}\t{sv.length}\t{cname}\n")
            recs = simulate_reads(rng, haps, coverage=args.coverage,
                                  read_len=args.read_len)
            del haps
            for lo in range(0, len(recs), SLICE_RECORDS):
                parts = []
                for rec in recs[lo:lo + SLICE_RECORDS]:
                    rec.tid = tid
                    rec.qname = f"c{tid}_{rec.qname}"
                    data = _encode_record(rec)
                    parts.append(struct.pack("<i", len(data)) + data)
                # release the slice's records as it is encoded
                recs[lo:lo + SLICE_RECORDS] = [None] * len(parts)
                if pending is not None:
                    pending.result()
                pending = pool.submit(deflate, b"".join(parts), 3)
                del parts
            n_reads += len(recs)
            log(f"[simulate] {cname}: {len(recs)} reads")
            del recs
        if pending is not None:
            pending.result()
    deflate(b"", 1)           # the BGZF EOF block
    return n_reads


# -------------------------------------------------------------- pipeline

def parse_line(out: dict, line: str) -> bool:
    """Read one line of a `cli run` log into `out`: stage seconds, the
    index's symbols, the anchor tables' kind and build, the smoother's XF
    counts, the engine the search took and its host redos. Returns whether
    the line finished a stage."""
    st = out.setdefault("stage_s", {})
    if m := _LOG["index"].search(line):
        st["index"] = float(m.group(1))
        out["index_symbols"] = int(m.group(2))
    elif m := _LOG["anchor_build"].search(line):
        st["anchor_build"] = float(m.group(3))
        out["wide_tables"] = m.group(1) == "WIDE anchor"
        out["anchor_k"] = int(m.group(2))
        out["anchor_build_peak_rss_gib"] = float(m.group(4))
    elif m := _LOG["smooth"].search(line):
        st["smooth"] = float(m.group(2))
        out["smooth_alignments"] = int(m.group(1))
        out["smooth_xf"] = dict(zip(("XF0", "XF1", "XF2", "XF3", "dropped"),
                                    map(int, m.group(3, 4, 5, 6, 7))))
    elif m := _LOG["search"].search(line):
        st["search"] = float(m.group(2))
        out["search_reads"] = int(m.group(1))
        out["fallbacks"] = int(m.group(3) or 0)
    elif m := _LOG["call"].search(line):
        st["call"] = float(m.group(2))
        out["svs"] = int(m.group(1))
    else:
        if m := _LOG["engine"].search(line):
            kind, detail = m.group(1), m.group(3)
            if kind == "FM":
                out["engine"] = "fm"
            elif kind == "anchor":
                out["engine"] = "anchor, one shot"   # until a pool line
            elif "parked-phase waves" in detail:
                out["engine"] = "wide anchor, parked-phase waves"
            else:
                out["engine"] = "wide anchor, one shot"
            out["engine_log"] = m.group(0)
            if t := _LOG["tables_gib"].search(detail):
                out["tables_gib"] = float(t.group(1))
        elif _LOG["pool"].search(line):
            out["engine"] = "anchor, pool"
        elif m := _LOG["cost_model"].search(line):
            out["cost_model_picks_fm"] = m.group(1)
        return False
    return True


def run_pipeline(args, ref: str, bam: str, wd: str, host: bool,
                 rep: C.Report, key: str) -> dict:
    """`cli run` as a child process, its log kept in WD.log and echoed to
    stderr, parsed line by line into rep[key] (flushed at every stage, so
    a run cut by the clock still shows how far it got)."""
    cmd = [*CLI, "run", "--reference", ref, "--bam", bam, "--workdir", wd,
           "--threads", str(args.threads)]
    if host:
        cmd.append("--no-device")
    else:
        cmd += ["--device", args.device]
    if args.engine:
        cmd += ["--engine", args.engine]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (C.PKG_PARENT, env.get("PYTHONPATH")) if p)
    rec = rep[key] = {"cmd": cmd[len(CLI):], "stage_s": {}}
    rep.flush()
    t0 = time.time()
    with open(wd + ".log", "w") as logf:
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=C.PKG_PARENT)
        try:
            for line in proc.stderr:
                logf.write(line)
                sys.stderr.write(line)
                if parse_line(rec, line.rstrip("\n")):
                    rep.flush()
            proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rec.update(rc=proc.returncode, pipeline_s=time.time() - t0,
               children_peak_rss_gib=resource.getrusage(
                   resource.RUSAGE_CHILDREN).ru_maxrss / 2 ** 20)
    rep.flush()
    return rec


# ---------------------------------------------------------------- scoring

def score(truth_rows: List[List[str]], vcf_lines: List[str]) -> dict:
    """The 200 bp rule of tools/chr_scale.py: a planted SV (type, pos,
    length[, chromosome]) is recovered if a VCF record of its SVTYPE on
    its chromosome lies within 200 bp, and a call is a true positive if it
    so matches any planted SV. recall, precision and F1 rounded to 4
    places, as that tool reports them."""

    def matches(ty: str, pos: int, chrom, line: str) -> bool:
        f = line.split("\t")
        return (f"SVTYPE={ty}" in line
                and (chrom is None or f[0] == chrom)
                and abs(int(f[1]) - pos) < 200)

    def hit(row, line):
        return matches(row[0], int(row[1]),
                       row[3] if len(row) > 3 else None, line)

    recovered = sum(1 for row in truth_rows
                    if any(hit(row, ln) for ln in vcf_lines))
    tp_calls = sum(1 for ln in vcf_lines
                   if any(hit(row, ln) for row in truth_rows))
    recall = recovered / max(1, len(truth_rows))
    precision = tp_calls / max(1, len(vcf_lines))
    f1 = (2 * recall * precision / (recall + precision)
          if recall + precision else 0.0)
    return {"planted": len(truth_rows), "recovered": recovered,
            "calls": len(vcf_lines), "recall": round(recall, 4),
            "precision": round(precision, 4), "f1": round(f1, 4)}


def disk_gib(root: str) -> float:
    """The blocks the files under `root` take, each inode once."""
    seen, total = set(), 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            st = os.lstat(os.path.join(dirpath, f))
            if st.st_ino not in seen:
                seen.add(st.st_ino)
                total += st.st_blocks * 512
    return total / 2 ** 30


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# -------------------------------------------------------------------- main

def main(argv: Optional[List[str]] = None, log=print) -> dict:
    args = parse(argv)
    dev = None if args.no_device or args.sim_only \
        else resolve_device(args.device)
    C.need_native()
    wd = os.path.abspath(args.workdir)
    if not args.keep and os.path.isdir(wd):
        shutil.rmtree(wd)
    os.makedirs(wd, exist_ok=True)
    out_path = args.out or os.path.join(wd, "report.json")
    if not args.keep and os.path.exists(out_path):
        os.remove(out_path)
    ref, bam = os.path.join(wd, "ref.fa"), os.path.join(wd, "reads.bam")
    truth_f = os.path.join(wd, "truth.txt")
    sim_f = os.path.join(wd, "sim.json")
    rep = C.Report(out_path, {
        "tool": "chr_scale", "genome_mbp": args.genome_mbp,
        "n_chrom": args.n_chrom, "coverage": args.coverage,
        "read_len": args.read_len, "n_sv": args.n_sv,
        "device": not args.no_device, "threads": args.threads,
        "seed": args.seed, "engine_arg": args.engine,
        "host": C.host_info(wd),
        "card": C.card_info(dev or torch.device("cpu"))})
    rep.flush()

    if os.path.exists(sim_f):
        with open(sim_f) as f:
            rep.update(json.load(f))
    else:
        with C.stage(rep, "simulate", log):
            n_reads = simulate(args, ref, bam, truth_f, log)
        sim = {"n_reads": n_reads, "sim_s": rep["stages"]["simulate"]["s"]}
        with open(sim_f, "w") as f:
            json.dump(sim, f)
        rep.update(sim)
    rep.flush()
    if args.sim_only:
        rep.update(ok=True, sim_only=True)
        rep.flush()
        return rep

    out = os.path.join(wd, "out")
    run = run_pipeline(args, ref, bam, out, args.no_device, rep, "run")
    rep.update(pipeline_s=run["pipeline_s"], stage_s=run["stage_s"],
               peak_rss_gib=run["children_peak_rss_gib"],
               engine="host" if args.no_device else run.get("engine"),
               wide_tables=run.get("wide_tables", False),
               index_symbols=run.get("index_symbols"),
               wide_by_size=run.get("index_symbols", 0) >= C.WIDE_BY_SIZE,
               fallbacks=run.get("fallbacks"),
               **{k: run[k] for k in RUN_KEYS if k in run})
    if run["rc"] != 0:
        rep.update(ok=False, rc=run["rc"])
        rep.flush()
        return rep
    with open(truth_f) as f:
        truth = [ln.rstrip("\n").split("\t") for ln in f]
    with open(os.path.join(out, "variations.vcf")) as f:
        vcf = [ln for ln in f if not ln.startswith("#")]
    rep.update(score(truth, vcf))
    ok = rep["recovered"] == rep["planted"]

    if args.check_host:
        hd = os.path.join(wd, "out_host")
        os.makedirs(hd, exist_ok=True)
        for f in ("index.fmd.npz", "smoothed.bam"):
            if not os.path.exists(os.path.join(hd, f)):
                os.link(os.path.join(out, f), os.path.join(hd, f))
        hrun = run_pipeline(args, ref, bam, hd, True, rep, "host_run")
        same = hrun["rc"] == 0 and all(
            same_bytes(os.path.join(out, f), os.path.join(hd, f))
            for f in ("specifics.txt", "variations.vcf"))
        rep.update(host_identical=same, host_stage_s=hrun["stage_s"],
                   host_pipeline_s=hrun["pipeline_s"])
        ok = ok and same
    else:
        rep["host_identical"] = None
    rep.update(ok=ok, disk_gib=disk_gib(wd))
    rep.flush()
    return rep


# the keys of the JAX tool's line, and this tool's own
SUMMARY = ("ok", "genome_mbp", "n_chrom", "coverage", "read_len", "n_reads",
           "planted", "recovered", "calls", "recall", "precision", "f1",
           "sim_s", "stage_s", "pipeline_s", "device", "threads", "seed",
           "engine", "wide_tables", "wide_by_size", "index_symbols",
           "peak_rss_gib", "disk_gib", "fallbacks", *RUN_KEYS,
           "host_identical", "host_stage_s", "host_pipeline_s", "card", "rc",
           "sim_only")


if __name__ == "__main__":
    rep = main(log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps({k: rep[k] for k in SUMMARY if k in rep}))
    sys.exit(0 if rep.get("ok") else 1)
