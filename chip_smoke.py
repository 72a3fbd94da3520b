#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (svdss_tpu_torch).

    python3 chip_smoke.py [--seed 21] [--keep]

Needs one CUDA card, nvcc (for the kernels in svdss_tpu_torch/csrc/) and
g++ (for the native host library in native/); both are built from the
checkout at first use. Phases, each printing one JSON line:

  env      the card's name and power limit (nvidia-smi), torch and CUDA
           versions, the native library's and the kernels' build times;
  kernels  each hand-written kernel against its plain PyTorch version on
           the card, on the same inputs, exactly (tolerance 0: every output
           is an integer): the FM ping-pong kernel on a read mix over a
           1 Mbp genome (with forced overflow and step-budget cases, and
           64 lanes held against the host oracle), the wavefront DP kernel
           at the call stage's buckets (CIGARs held against the host DP);
  run      the main path, ``cli run --engine fm``, on a seed-pinned 40 Mbp
           diploid sample (the sample of tools/chr_scale.py, simulated
           with the port's own simulator), then the host engines
           (``--no-device``) on the same index and smoothed BAM: the two
           specifics.txt and VCF files must be identical, and recall and
           precision are scored against the planted SVs;
  timing   each kernel and its plain version timed with CUDA events on the
           inputs the main path gave it, and the least time the card could
           take for the same work.

Then the card's nvidia-smi line, the kernel table as one JSON line, and
last ``{"ok": true, "device": {...}}``. Any failed phase raises: the exit
code is then not 0 and no result line is printed. Without a card it stops
at once with exit code 2.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the scalar
# (non-tensor-core) 32-bit rate. The kernels do int32 work; the data sheet
# gives no int32 rate, and the fp32 one is at least as high, so bounds
# computed with it are lower bounds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# integer operations the work needs, counted from the recurrences:
# one rank step is 32 packed words x (xor, add, and-not, mask, popcount,
# accumulate) plus ~8 for the interval update; one DP cell is ~40 (four
# gap states at 4 each, the substitution at 3, the four-way max with
# its source at 12, the band mask at 3, the trace bits at 8, the score
# capture)
OPS_PER_RANK_STEP = 32 * 6 + 8
OPS_PER_DP_CELL = 40

# the run phase's sample: tools/chr_scale.py at its defaults, no cut
GENOME_MBP = 40                 # one chromosome, 80M two-strand symbols
COVERAGE = 30
READ_LEN = 12_000
N_SV = 60                       # 15 INS + 15 DEL of 50-400 bp per haplotype


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def once_ms(fn) -> float:
    """Time of one call of fn() on the card (for the slow plain versions)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def max_abs_diff(a, b) -> int:
    """Largest absolute difference of two tuples of integer tensors (0 when
    equal); a shape mismatch counts as infinitely far."""
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return 2 ** 62
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


# ------------------------------------------------------------------ env

def phase_env() -> dict:
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.time()
    build = subprocess.run(["make", "-s", "-C", os.path.join(HERE, "native")],
                           capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError("native library build failed:\n" + build.stdout
                           + build.stderr)
    native_s = time.time() - t0
    from svdss_tpu_torch.io import native
    if native.load() is None:
        raise RuntimeError("native library did not load")
    from svdss_tpu_torch.utils.device import build_info, load_kernels
    load_kernels()
    for name, log in build_info.get("ptxas", {}).items():
        sys.stderr.write(f"--- ptxas {name}.cu\n{log}\n")
    info = {"phase": "env", "gpu": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "native_build_s": round(native_s, 3),
            "kernel_build_s": round(build_info["seconds"], 3),
            "kernels_built": build_info["built"]}
    emit(info)
    return info


# -------------------------------------------------------------- kernels

def read_mix(g: str, rng) -> list:
    """Clean, mutated, reverse-complement, N-containing, random and
    inserted reads (the mix of tests/test_pingpong_device.py)."""
    from svdss_tpu_torch.utils.seq import revcomp_str
    reads = []
    for trial in range(24):
        ln = int(rng.integers(120, 500))
        p = int(rng.integers(0, len(g) - ln))
        read = list(g[p:p + ln])
        for _ in range(int(rng.integers(0, 5))):
            read[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        read = "".join(read)
        if trial % 3 == 0:
            read = revcomp_str(read)
        if trial % 7 == 0:
            read = read[:50] + "N" + read[50:]
        reads.append(read)
    reads.append("".join("ACGT"[i] for i in rng.integers(0, 4, 200)))
    ins = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    reads.append(g[100:300] + ins + g[300:500])
    return reads


def long_reads(g: str, rng, n: int) -> list:
    """n reads of 2-12 kb: genome samples on either strand with 0.3% SNVs,
    a quarter with a 20-400 bp random insertion, an eighth with an N, and
    one in sixteen fully random (SFS-dense, so some overflow the cap)."""
    from svdss_tpu_torch.utils.seq import revcomp_str
    reads = []
    for k in range(n):
        ln = int(rng.integers(2000, 12001))
        if k % 16 == 15:
            reads.append("".join("ACGT"[i] for i in rng.integers(0, 4, ln)))
            continue
        p = int(rng.integers(0, len(g) - ln))
        read = np.frombuffer(g[p:p + ln].encode(), dtype=np.uint8).copy()
        snv = rng.random(ln) < 0.003
        read[snv] = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, int(snv.sum()))]
        read = read.tobytes().decode()
        if k % 4 == 1:
            at = int(rng.integers(0, ln))
            read = read[:at] + "".join(
                "ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(
                    20, 401)))) + read[at:]
        if k % 8 == 3:
            at = int(rng.integers(0, len(read)))
            read = read[:at] + "N" + read[at + 1:]
        if k % 2:
            read = revcomp_str(read)
        reads.append(read)
    return reads


def check_pingpong(rng) -> dict:
    from svdss_tpu_torch.index.fmd import build_index
    from svdss_tpu_torch.ops import pingpong
    from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
    from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
    from svdss_tpu_torch.pipeline.search import _bucket_len
    from svdss_tpu_torch.utils.seq import encode_nt6

    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 1_000_000))
    index = build_index({"g": g})
    dev = DeviceFMDIndex.from_host(index, "cuda")
    reads = read_mix(g, rng) + long_reads(g, rng, 512)
    enc = [encode_nt6(r) for r in reads]
    L = _bucket_len(max(len(e) for e in enc))
    fields = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")
    cases = []

    def compare(name, encs, **kw):
        seqs, lens = pingpong.pack_reads(encs, pad_to=L, device="cuda")
        before = pingpong.launches
        got = pingpong.batch_search(dev, seqs, lens, **kw)
        torch.cuda.synchronize()
        if pingpong.launches != before + 1:
            raise RuntimeError("batch_search did not launch the kernel")
        max_iters = kw.get("max_iters") or 8 * L + 64
        want = pingpong.batch_search_plain(
            dev, seqs, lens, kw["cap"], -(-max_iters // pingpong.K_INNER))
        err = max_abs_diff([getattr(got, f) for f in fields],
                           [getattr(want, f) for f in fields])
        cases.append({"case": name, "lanes": len(encs), "L": L,
                      "cap": kw["cap"], "max_abs_err": err,
                      "overflow": int(got.overflow.sum()),
                      "incomplete": int(got.incomplete.sum()),
                      "iters": int(got.iters)})
        return got

    cap = max(128, L // 16)             # the search stage's cap
    res = compare("read mix + 512 long reads", enc, cap=cap)
    compare("cap=2 overflow", enc[:64], cap=2)
    compare("max_iters=200 incomplete", enc[:64], cap=cap, max_iters=200)
    # 64 lanes against the host oracle: the shortest finished lanes
    n_sfs = res.n_sfs.cpu().numpy()
    qs, ln = res.qs.cpu().numpy(), res.length.cpu().numpy()
    done = ~(res.overflow | res.incomplete).cpu().numpy()
    order = sorted((i for i in range(len(enc)) if done[i]),
                   key=lambda i: len(enc[i]))[:64]
    oracle_bad = 0
    for i in order:
        k = int(n_sfs[i])
        got = list(zip(qs[i, :k].tolist(), ln[i, :k].tolist()))
        oracle_bad += got != ping_pong_search(index, enc[i])
    mismatches = sum(c["max_abs_err"] > 0 for c in cases) + oracle_bad
    return {"name": "pingpong_fm", "cases": cases,
            "oracle_lanes": len(order), "oracle_mismatches": oracle_bad,
            "mismatches": mismatches,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def dp_pairs(rng, n: int, bq: int, bt: int) -> list:
    """n (query, target) pairs for one call-stage bucket: targets of
    bt/2..bt symbols, queries carrying 0.5% SNVs and one 25-2000 bp
    insertion or deletion, cut to bq."""
    pairs = []
    for k in range(n):
        t = rng.integers(1, 5, int(rng.integers(bt // 2 + 1, bt + 1)))
        q = t.copy()
        snv = rng.random(len(q)) < 0.005
        q[snv] = rng.integers(1, 5, int(snv.sum()))
        size = int(rng.integers(25, max(26, min(2000, bq // 2) + 1)))
        at = int(rng.integers(0, len(q)))
        if k % 2:
            q = np.concatenate([q[:at], rng.integers(1, 5, size), q[at:]])
        else:
            q = np.concatenate([q[:at], q[at + size:]])
        q = q[:bq]
        pairs.append((q.astype(np.int32), t.astype(np.int32)))
    return pairs


def pack_pairs(pairs, lq: int, lt: int):
    B = len(pairs)
    q = np.full((B, lq), -3, dtype=np.int32)
    t = np.full((B, lt), -4, dtype=np.int32)
    for b, (qa, ta) in enumerate(pairs):
        q[b, :len(qa)] = qa
        t[b, :len(ta)] = ta
    tgt_d = np.array([len(a) + len(b) for a, b in pairs], dtype=np.int32)
    tgt_i = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, t, tgt_d, tgt_i)]


def check_wavefront(rng) -> dict:
    from svdss_tpu_torch.ops import align_dp
    from svdss_tpu_torch.ops.align import align_dual_gap
    from svdss_tpu_torch.pipeline.call import _CALL_PARAMS

    cases = []
    cigar_checked = cigar_bad = 0
    # the call stage's power-of-two buckets, each at its chunk size
    # (pipeline/call.py pcall); 8192 x 512 runs the DP state out of
    # shared memory (W > 6456 on an H100) through the global scratch
    for bq, bt in ((256, 256), (512, 512), (2048, 2048), (4096, 4096),
                   (8192, 512)):
        B = max(8, min(128, (256 << 20) // ((bq + bt) * (bq + 1))))
        pairs = dp_pairs(rng, B, bq, bt)
        args = pack_pairs(pairs, bq, bt)
        before = align_dp.launches
        got = align_dp.wavefront(*args, bq, bt, _CALL_PARAMS)
        torch.cuda.synchronize()
        if align_dp.launches != before + 1:
            raise RuntimeError("wavefront did not launch the kernel")
        want = align_dp.wavefront_plain(*args, bq, bt, _CALL_PARAMS)
        err = max_abs_diff(got, want)
        cases.append({"case": f"{bq}x{bt}", "pairs": B, "max_abs_err": err,
                      "global_scratch": align_dp.scratch_words(
                          bq, args[0].device) > 0})
        # CIGARs and scores against the host DP on a sample
        trace = got[0].cpu().numpy()
        score = got[1].cpu().numpy()
        for b in range(2 if bq * bt <= 2048 * 2048 else 1):
            qa, ta = pairs[b]
            mine = (int(score[b]),
                    align_dp.traceback(trace[b], len(qa), len(ta)))
            cigar_bad += mine != align_dual_gap(qa, ta, _CALL_PARAMS)
            cigar_checked += 1
        del got, want, trace
    if not any(c["global_scratch"] for c in cases):
        raise RuntimeError("no wavefront case ran the global-scratch path")
    mismatches = sum(c["max_abs_err"] > 0 for c in cases) + cigar_bad
    return {"name": "wavefront_dp", "cases": cases,
            "cigars_checked": cigar_checked, "cigar_mismatches": cigar_bad,
            "mismatches": mismatches,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def phase_kernels(seed: int) -> dict:
    t0 = time.time()
    rng = np.random.default_rng(seed)
    checks = [check_pingpong(rng), check_wavefront(rng)]
    emit({"phase": "kernels", "seconds": round(time.time() - t0, 3),
          "tolerance": 0, "checks": checks})
    bad = [c["name"] for c in checks if c["mismatches"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    return {c["name"]: c["max_abs_err"] for c in checks}


# ------------------------------------------------------------------ run

def simulate(wd: str, seed: int) -> dict:
    """The sample of tools/chr_scale.py at its defaults (one chromosome),
    made with the port's simulator from the same seed and the same calls."""
    from svdss_tpu_torch.io.fasta import write_fasta
    from svdss_tpu_torch.utils.simulate import (make_haplotype,
                                                random_genome,
                                                simulate_reads, write_bam)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    chroms = random_genome(rng, {"chr1": GENOME_MBP * 1_000_000})
    write_fasta(os.path.join(wd, "ref.fa"), chroms)
    sv_per_hc = N_SV // 4
    truth = []
    haps = []
    for _ in range(2):
        h = make_haplotype(rng, "chr1", chroms["chr1"], n_ins=sv_per_hc,
                           n_del=sv_per_hc, min_len=50, max_len=400)
        haps.append(h)
        truth += [(sv.type, sv.pos) for sv in h.svs]
    recs = simulate_reads(rng, haps, coverage=COVERAGE, read_len=READ_LEN)
    for rec in recs:
        rec.tid = 0
        rec.qname = f"c0_{rec.qname}"
    write_bam(os.path.join(wd, "reads.bam"), chroms, recs,
              threads=os.cpu_count() or 2)
    return {"reads": len(recs), "truth": truth,
            "seconds": time.time() - t0}


class LogTap(logging.Handler):
    """Keeps the pipeline's log messages, for the search stage's counts."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def grab(self, pattern: str):
        for line in self.lines:
            m = re.search(pattern, line)
            if m:
                return m
        raise RuntimeError(f"no log line matches {pattern!r}")


# the stage functions `cli run` calls; it imports each from its module at
# call time, so replacing the module's attribute times the stage
STAGES = (("index", "svdss_tpu_torch.index.fmd", "build_index"),
          ("smooth", "svdss_tpu_torch.pipeline.smooth", "run_smooth"),
          ("search", "svdss_tpu_torch.pipeline.search", "run_search"),
          ("call", "svdss_tpu_torch.pipeline.call", "run_call"))


class StageTimer:
    """Unrounded wall seconds of each stage of one `cli run`, stopped once
    the card has finished the stage's work."""

    def __init__(self):
        self.seconds = {}
        self.saved = []
        for stage, modname, name in STAGES:
            mod = importlib.import_module(modname)
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._timed(stage, fn))

    def _timed(self, stage, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                       + time.perf_counter() - t0)
        return timed

    def restore(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def stages(self, *required) -> dict:
        missing = [s for s in required if s not in self.seconds]
        if missing:
            raise RuntimeError(f"stages never ran: {missing}")
        return dict(self.seconds)


def score_calls(vcf_path: str, truth) -> dict:
    calls = []
    for line in open(vcf_path):
        if line.startswith("#"):
            continue
        f = line.split("\t")
        ty = re.search(r"SVTYPE=(\w+)", f[7])
        calls.append((ty.group(1) if ty else "", int(f[1])))

    def near(a, b):
        return a[0] == b[0] and abs(a[1] - b[1]) < 200

    found = sum(any(near(t, c) for c in calls) for t in truth)
    true_calls = sum(any(near(c, t) for t in truth) for c in calls)
    return {"planted": len(truth), "recovered": found, "calls": len(calls),
            "recall": found / max(len(truth), 1),
            "precision": true_calls / max(len(calls), 1)}


class Spy:
    """Wraps a function to keep the inputs of the main path's largest
    launch (for timing the kernel on exactly those inputs afterwards)."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.fn = getattr(module, name)
        self.best = None
        self.shapes = {}
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        key, size = self.size(*args, **kw)
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if self.best is None or size > self.best[0]:
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
            self.best = (size, kept, dict(kw))
        return self.fn(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def phase_run(wd: str, args) -> dict:
    from svdss_tpu_torch import cli
    from svdss_tpu_torch.ops import align_dp, pingpong
    from svdss_tpu_torch.pipeline import search as search_mod
    from svdss_tpu_torch.utils.log import logger

    sim = simulate(wd, args.seed)
    ref, bam = os.path.join(wd, "ref.fa"), os.path.join(wd, "reads.bam")
    dev_wd, host_wd = os.path.join(wd, "device"), os.path.join(wd, "host")
    threads = str(os.cpu_count() or 4)

    spies = [Spy(search_mod, "batch_search",
                 lambda idx, seqs, lens, **kw: (
                     (tuple(seqs.shape), kw.get("cap")), seqs.numel())),
             Spy(align_dp, "wavefront",
                 lambda q, t, td, ti, lq, lt, p=None: (
                     (q.shape[0], lq, lt), q.shape[0] * (lq + lt) * lq))]
    tap = LogTap()
    logger.addHandler(tap)
    timer = StageTimer()
    try:
        pingpong.launches = 0
        align_dp.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["run", "--reference", ref, "--bam", bam,
                       "--workdir", dev_wd, "--engine", "fm",
                       "--threads", threads])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"pingpong_fm": pingpong.launches,
                    "wavefront_dp": align_dp.launches}
    finally:
        timer.restore()
        for s in spies:
            s.restore()
        logger.removeHandler(tap)
    if rc != 0:
        raise RuntimeError(f"run exited {rc}")
    dev_stages = timer.stages("index", "smooth", "search", "call")
    m = tap.grab(r"search: (\d+) reads in .*?(\d+) host fallbacks")
    n_reads, redo = int(m.group(1)), int(m.group(2))

    # the host engines on the same index and smoothed BAM
    os.makedirs(host_wd)
    for f in ("index.fmd.npz", "smoothed.bam"):
        os.link(os.path.join(dev_wd, f), os.path.join(host_wd, f))
    timer = StageTimer()
    try:
        t0 = time.perf_counter()
        rc = cli.main(["run", "--reference", ref, "--bam", bam,
                       "--workdir", host_wd, "--no-device",
                       "--threads", threads])
        host_s = time.perf_counter() - t0
    finally:
        timer.restore()
    if rc != 0:
        raise RuntimeError(f"host run exited {rc}")
    host_stages = timer.stages("search", "call")

    same = {}
    for f in ("specifics.txt", "variations.vcf"):
        a = open(os.path.join(dev_wd, f), "rb").read()
        b = open(os.path.join(host_wd, f), "rb").read()
        same[f] = a == b and len(a) > 0
    quality = score_calls(os.path.join(dev_wd, "variations.vcf"),
                          sim["truth"])
    info = {"phase": "run", "genome_mbp": GENOME_MBP, "coverage": COVERAGE,
            "read_len": READ_LEN, "n_sv": N_SV, "reduced": [],
            "simulated_reads": sim["reads"], "simulate_s": sim["seconds"],
            "run_s": run_s, "stage_s": dev_stages,
            "search_reads": n_reads,
            "search_reads_per_s": n_reads / dev_stages["search"],
            "host_redo_reads": redo, "launches": launches,
            "pingpong_batches": {f"{k[0]} cap {k[1]}": v for k, v in
                                 spies[0].shapes.items()},
            "wavefront_buckets": {f"B{k[0]} {k[1]}x{k[2]}": v for k, v in
                                  spies[1].shapes.items()},
            "host_run_s": host_s, "host_stage_s": host_stages,
            "identical_to_host": same, **quality}
    emit(info)
    if not all(same.values()):
        raise RuntimeError(f"device output differs from the host: {same}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the main path never ran: "
                           f"{launches}")
    if quality["recall"] < 0.9:
        raise RuntimeError(f"recall {quality['recall']:.3f} below 0.9")
    return {"launches": launches, "spies": spies}


# --------------------------------------------------------------- timing

def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_pingpong(spy: Spy) -> dict:
    from svdss_tpu_torch.ops import pingpong
    _, (index, seqs, lens), kw = spy.best
    Q, Lp1 = seqs.shape
    cap = kw["cap"]
    work = torch.zeros(1, dtype=torch.int64, device=seqs.device)
    got = pingpong.batch_search(index, seqs, lens, work=work, **kw)
    torch.cuda.synchronize()
    steps = int(work.item())
    ms = cuda_ms(lambda: pingpong.batch_search(index, seqs, lens, **kw), 5)
    max_outer = -(-(8 * (Lp1 - 1) + 64) // pingpong.K_INNER)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", pingpong.batch_search_plain(index, seqs, lens, cap, max_outer,
                                         kw.get("overlap", -1))))
    fields = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")
    err = max_abs_diff([getattr(got, f) for f in fields],
                       [getattr(holder["r"], f) for f in fields])
    # bytes: each lane's symbols and its sentinel once (a padding lane
    # holds one symbol), the lengths once, the rows the walk touches once
    # (never more than the whole table), the outputs once
    table = index.fused.numel() * 4
    read_bytes = int((lens.long() + 1).sum())
    nbytes = (read_bytes + 4 * Q + min(table, steps * 192) + 8 * Q * cap
              + 6 * Q + 4)
    bms, by = bound(nbytes, steps * OPS_PER_RANK_STEP)
    return {"shape": f"Q={Q} L+1={Lp1} cap={cap}", "rank_steps": steps,
            "read_bytes": read_bytes, "bound_bytes": nbytes,
            "table_MiB": table / 2 ** 20, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}


def time_wavefront(spy: Spy) -> dict:
    from svdss_tpu_torch.ops import align_dp
    _, args, kw = spy.best
    q, t, td, ti, lq, lt = args[:6]
    p = args[6] if len(args) > 6 else kw.get("params")
    B = q.shape[0]
    W, D = lq + 1, lq + lt + 1
    got = align_dp.wavefront(q, t, td, ti, lq, lt, p)
    ms = cuda_ms(lambda: align_dp.wavefront(q, t, td, ti, lq, lt, p), 5)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", align_dp.wavefront_plain(q, t, td, ti, lq, lt, p)))
    err = max_abs_diff(got, holder["r"])
    nbytes = 4 * B * (lq + lt) + 8 * B + B * D * W + 4 * B
    bms, by = bound(nbytes, B * (D - 1) * W * OPS_PER_DP_CELL)
    return {"shape": f"B={B} lq={lq} lt={lt}", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def phase_timing(run: dict) -> dict:
    spies = run["spies"]
    out = {"pingpong_fm": time_pingpong(spies[0]),
           "wavefront_dp": time_wavefront(spies[1])}
    emit({"phase": "timing", **out})
    bad = [k for k, v in out.items() if v["max_abs_err"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the main path's shapes: {bad}")
    return out


# ----------------------------------------------------------------- main

KERNELS = (
    ("pingpong_fm", "svdss_tpu_torch/csrc/pingpong.cu",
     "svdss_tpu/ops/pingpong_jax.py:117"),
    ("wavefront_dp", "svdss_tpu_torch/csrc/wavefront.cu",
     "svdss_tpu/ops/align_pallas.py:181"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=21,
                    help="seed of the simulated data (tools/chr_scale.py "
                         "pins 21)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the work directory (build/chip_smoke)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA card is available\n")
        return 2
    sys.path.insert(0, HERE)
    import svdss_tpu_torch  # noqa: F401  (fails outside a checkout)

    wd = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    t0 = time.time()
    try:
        phase_env()
        errs = phase_kernels(args.seed)
        run = phase_run(wd, args)
        timing = phase_timing(run)
    finally:
        if not args.keep:
            shutil.rmtree(wd, ignore_errors=True)
    table = []
    for name, src, replaces in KERNELS:
        tm = timing[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces,
                      "launches": run["launches"][name],
                      "max_abs_err": max(errs[name], tm["max_abs_err"]),
                      "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                      "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                      "library_ms": None})
    sys.stderr.write(f"chip_smoke: {time.time() - t0:.1f}s\n")
    print(nvidia_smi(), flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
