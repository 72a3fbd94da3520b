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
           64 lanes held against the host oracle); the one-shot anchor
           kernel on the anchor read mix and 512 long reads over another
           1 Mbp genome (forced overflow, round-limit, overlap 0 and
           heavy-k-mer cases; 64 lanes against the host oracle), and on
           the reads of lane_edge_case, aimed at its key and compare steps
           (with overflow, overlap 0 and per-lane budget variants); the
           pool kernel on a stream longer than its lane count with 1, 33
           and 4,096 reads in flight, against the one-shot kernel under the
           same per-lane budget and across the three, and on the edge
           reads; the FM kernel's
           wide mode at limb widths 31 and 17 (high limbs zero, then
           not), also against narrow K2; the wide anchor kernel, one shot
           and in parked-phase waves, on the wide table variants over a
           1 Mbp genome and a repeat-rich genome whose heavy anchors park
           lanes (64 lanes against the host oracle), and on the reads of
           wide_edge_case, aimed at its key and compare steps; the
           wavefront DP kernel at the call stage's buckets (CIGARs against
           the host DP) and at DP_EDGE_CASES, widths around each of its
           path limits;
           the jump-table kernel at k = 1, 6 and 8 over the FM check's
           genome, and the FM kernel's jump mode with that genome's 6-mer
           table on its read mix (with the overflow and step-budget
           cases), whose complete lanes equal the search without jumps in
           no more steps; the FM kernel on the reads of
           pingpong_edge_case (spans ending at 256 symbols, pending and
           sentinel steps, safe_b's edge) narrow, wide at limb widths 12
           (low limbs carry) and 31, and in jump mode at k = 4 and 6, and
           the jump-table kernel on that genome at k = 1, 4, 6 and 8
           (mostly absent 8-mers);
  run      the main path, ``cli run`` with the default engine choice, on a
           seed-pinned 40 Mbp diploid sample (the sample of
           tools/chr_scale.py, simulated with the port's own simulator):
           at 80M symbols it builds anchor tables and takes the narrow
           anchor engine through the pool. Then, on the same index, anchor
           tables and smoothed BAM, the one-shot anchor engine
           (``--engine anchor --no-pool``), the FM engine (``--engine
           fm``) and the host engines (``--no-device``), and with the
           JAX package's wide switch (``SVDSS_TPU_WIDE_ANCHOR=1``, its own
           wide tables, default engine: the wide anchor engine in waves),
           and the FM engine with ``Config.kmer_jump = 12`` (the jump table
           built by 11 launches of its kernel, then the FM kernel's jump
           mode): the six specifics.txt and VCF files must be identical, and
           recall and precision are scored against the planted SVs. Each
           run's kernel launches are counted from 0;
  timing   each kernel and its plain version timed with CUDA events on the
           inputs the main path gave it (the anchor kernels with their time
           a round of the slowest read; the DP kernel with its time a
           diagonal, also on the call stage's 2048 x 2048 and 4096 x 4096
           chunks; K2's wide mode on the force-wide
           table of the run's index with the FM run's reads; the 12-mer
           jump table of the run's index, held whole against its plain
           version; K2's jump mode on the FM run's reads with that table,
           with its rank steps beside those without jumps; K2's µs a step
           in all three modes, over the slowest lane's steps; K6's
           instructions a parent, its source note's SASS counts over the
           run's parents of each kind, and their time at Hopper's
           integer issue rates), and the least time the card could take
           for the same work.

The env line carries each kernel's registers and spills (nvcc's
``-Xptxas -v``). Then the card's nvidia-smi line, the kernel table as one
JSON line, and last ``{"ok": true, "device": {...}}``. Any failed phase raises: the exit
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
# an anchor round's state machine outside its loops (mode decode, row and
# column offsets, the table-row dispatch, resolution, restart and state
# updates: ~60 integer operations), and per symbol a verify round compares
# two symbol fetches, the compare and the loop test
OPS_PER_ANCHOR_ROUND = 60
OPS_PER_COMPARED_SYMBOL = 4
# a jump-table parent: at each of its two endpoints, 32 packed words x 5
# symbols x (xor, add, and-not, mask, popcount, accumulate); then 4
# children of ~8 each. A jump-mode lookup: the key, ~4 a symbol, and the
# row's tests
OPS_PER_JUMP_PARENT = 2 * 32 * 5 * 6 + 4 * 8
OPS_PER_KEY_SYMBOL = 4
# the instructions kernel K6 issues for a parent of each kind, as its
# source note counts them (the SASS of jump_level_kernel for sm_90a, path
# by path): absent (sz 0), both endpoints in one fused row, in two rows;
# and the popcounts among them
JUMP_PARENT_INSNS = {"absent": 44, "one_row": 341, "two_rows": 456}
JUMP_PARENT_POPC = {"absent": 0, "one_row": 40, "two_rows": 40}
# Hopper's 32-bit integer issue (64 lanes an SM a clock, 16 for popcount)
# at the H100 SXM's 1.98 GHz boost clock over its 132 SMs
INT_LANES_PER_S = 132 * 64 * 1.98e9
POPC_LANES_PER_S = 132 * 16 * 1.98e9
# the sixth run's k, and the k of the kernels phase's jump checks
RUN_JUMP_K = 12
CHECK_JUMP_K = 6

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
            "kernels_built": build_info["built"],
            "ptxas": {f"{name}.cu": ptxas_usage(log) for name, log in
                      build_info.get("ptxas", {}).items()}}
    emit(info)
    return info


def ptxas_usage(log: str) -> list:
    """Each kernel's registers, stack frame and spills from nvcc's
    `-Xptxas -v` output, in the order they were compiled."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?\d([a-z][a-z_]*_kernel)", line)
        if m:
            out.append({"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


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


PP_EDGE_LIMB = 12   # the wide edge table's low-limb width


def pingpong_edge_case(seed: int = 9):
    """(genome, nt6 reads) aimed at the FM lane machine's edges (kernel K2,
    all three modes): a 26 kb genome (random; a 40 bp unit 150 times and a
    30 bp unit 220 times, whose substrings keep intervals of ~150 and ~220
    over many steps; an N run) and reads that give rank steps whose
    interval ends exactly at the 256-symbol span and one past it (pending
    steps), forward extensions into a $ inside the read (the sentinel
    step: the rest of the read is the start of a strand, so $ + rest is in
    the index), SFS-dense reads that overflow a small cap, and reads of
    300-1,100 symbols whose restarts meet the jump test safe_b's edge from
    both sides. With the limb-12 wide table the ranks' low limbs carry
    past 2^12. tests/test_torch_pingpong_lanes.py shows that
    each of these is reached."""
    from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_nt6
    rng = np.random.default_rng(seed)

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def snv(r, at):
        r = r.copy()
        r[at] = r[at] % 4 + 1
        return r
    ua, ub = rand(40), rand(30)
    g = (rand(8_000) + ua * 150 + rand(3_000) + ub * 220 + "N" * 50
         + rand(2_400))
    enc = encode_nt6(g)
    a0, b0 = 8_000, 8_000 + 6_000 + 3_000
    reads = []
    # reads inside the tandem repeats, both strands, some with an SNV
    for s0, n in ((a0 + 100, 400), (a0 + 2_017, 900), (b0 + 55, 500),
                  (b0 + 3_001, 1_100)):
        r = enc[s0:s0 + n].copy()
        reads += [r, revcomp_nt6(r), snv(r, n // 3)]
    # across the repeats' borders, with SNVs
    for s0 in (a0 - 150, a0 + 5_900, b0 - 200, b0 + 6_450):
        r = snv(enc[s0:s0 + 400].copy(), 201)
        reads += [r, revcomp_nt6(r)]
    # a $ inside the read: X + $ + the start of a strand (the reverse
    # strand starts with revcomp of the genome's end)
    tail = revcomp_nt6(enc[-300:])
    for x in range(4):
        reads.append(np.concatenate([encode_nt6(rand(60 + 7 * x)),
                                     np.zeros(1, np.uint8), tail[:200]]))
    reads.append(np.concatenate([encode_nt6(rand(80)), np.zeros(1, np.uint8),
                                 encode_nt6(g[:150])]))
    # SFS-dense random reads and genome reads with SNVs every ~30 bp, of
    # 300-1,100 symbols
    for n in (300, 517, 700, 901, 1_100):
        reads.append(encode_nt6(rand(n)))
        s0 = int(rng.integers(0, 8_000 - n))
        r = enc[s0:s0 + n].copy()
        for at in range(5, n, 31):
            r = snv(r, at)
        reads.append(r)
    # genome reads with one SNV at 0-60 symbols from their start, so the
    # last phases sit near the read's start
    for at in range(0, 61, 4):
        s0 = int(rng.integers(0, 8_000 - 350))
        reads.append(snv(enc[s0:s0 + 350].copy(), at))
    return g, reads


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
    reads = read_mix(g, rng)
    n_mix = len(reads)
    reads += long_reads(g, rng, 512)
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
    return [{"name": "pingpong_fm", "cases": cases,
             "oracle_lanes": len(order), "oracle_mismatches": oracle_bad,
             "mismatches": mismatches,
             "max_abs_err": max(c["max_abs_err"] for c in cases)},
            *check_jump(dev, enc, n_mix, L, cap)]


def check_jump(dev, enc, n_mix: int, L: int, cap: int) -> list:
    """K6 against its plain version at k = 1, 6 and 8 on the FM check's
    genome (the whole table); K2's jump mode with the 6-mer table against
    its plain jump version in all six fields, on the FM check's read mix
    (its first `n_mix` reads, padded as the whole batch) and on the
    overflow and step-budget cases of its first 64 reads; and on the read
    mix's lanes complete with and without jumps, K2 with jumps against K2
    without: the same SFS lists, and iters not larger. (The timing phase
    holds the jump mode against its plain version on the main path's
    reads.)"""
    from svdss_tpu_torch.ops import fmd, pingpong
    tables, cases = {}, []
    for k in (1, CHECK_JUMP_K, 8):
        before = fmd.launches
        got = fmd.build_jump_table(dev, k)
        torch.cuda.synchronize()
        if fmd.launches != before + k - 1:
            raise RuntimeError(f"build_jump_table({k}) launched K6 "
                               f"{fmd.launches - before} times, not {k - 1}")
        want = fmd.build_jump_table_plain(dev, k)
        tables[k] = got
        cases.append({"case": f"k={k}", "rows": 4 ** k,
                      "present": int((got[:, 2] > 0).sum()),
                      "max_abs_err": max_abs_diff([got], [want])})
    k6 = {"name": "jump_level", "cases": cases,
          "mismatches": sum(c["max_abs_err"] > 0 for c in cases),
          "max_abs_err": max(c["max_abs_err"] for c in cases)}

    table = tables[CHECK_JUMP_K]
    seqs, lens = pingpong.pack_reads(enc, pad_to=L, device="cuda")
    nojump = pingpong.batch_search(dev, seqs[:n_mix], lens[:n_mix], cap=cap)
    jcases = []
    for name, n, kw in (("read mix", n_mix, dict(cap=cap)),
                        ("cap=2 overflow", 64, dict(cap=2)),
                        ("max_iters=200 incomplete", 64,
                         dict(cap=cap, max_iters=200))):
        before = pingpong.launches
        got = pingpong.batch_search(dev, seqs[:n], lens[:n], jump_table=table,
                                    jump_k=CHECK_JUMP_K, **kw)
        torch.cuda.synchronize()
        if pingpong.launches != before + 1:
            raise RuntimeError("batch_search did not launch K2 (jump mode)")
        max_iters = kw.get("max_iters") or 8 * L + 64
        want = pingpong.batch_search_plain(
            dev, seqs[:n], lens[:n], kw["cap"],
            -(-max_iters // pingpong.K_INNER), jump_table=table,
            jump_k=CHECK_JUMP_K)
        case = {"case": f"k={CHECK_JUMP_K}: {name}", "lanes": n, "L": L,
                "cap": kw["cap"],
                "max_abs_err": max_abs_diff(
                    [getattr(got, f) for f in PP_FIELDS],
                    [getattr(want, f) for f in PP_FIELDS]),
                "overflow": int(got.overflow.sum()),
                "incomplete": int(got.incomplete.sum()),
                "iters": int(got.iters)}
        if n == n_mix:
            # complete lanes, with and without jumps: the same SFS lists
            done = ~(got.overflow | got.incomplete | nojump.overflow
                     | nojump.incomplete)
            case["complete_lanes"] = int(done.sum())
            case["iters_without_jumps"] = int(nojump.iters)
            case["vs_nojump_max_abs_err"] = max_abs_diff(
                [got.qs[done], got.length[done], got.n_sfs[done]],
                [nojump.qs[done], nojump.length[done], nojump.n_sfs[done]])
            if int(got.iters) > int(nojump.iters):
                case["vs_nojump_max_abs_err"] = max(
                    case["vs_nojump_max_abs_err"], 1)
        jcases.append(case)
    errs = [max(c["max_abs_err"], c.get("vs_nojump_max_abs_err", 0))
            for c in jcases]
    return [k6, {"name": "pingpong_fm_jump", "cases": jcases,
                 "mismatches": sum(e > 0 for e in errs),
                 "max_abs_err": max(errs)}]


def anchor_mix(enc: np.ndarray, rng, n: int = 48, L: int = 300) -> list:
    """The read mix of tests/test_anchor_jax.py (nt6): clean, mutated,
    inserted, reverse-complement, random and N-containing reads, plus
    short and edge reads and one exact 500-symbol read."""
    from svdss_tpu_torch.utils.seq import revcomp_nt6
    out = []
    for i in range(n):
        s = int(rng.integers(0, len(enc) - L))
        r = enc[s:s + L].copy()
        kind = i % 6
        if kind == 1:
            for _ in range(4):
                r[rng.integers(0, L)] = rng.integers(1, 5)
        elif kind == 2:
            at = int(rng.integers(50, L - 50))
            r = np.concatenate([r[:at], rng.integers(1, 5, 30)
                                .astype(np.uint8), r[at:]])
        elif kind == 3:
            r = revcomp_nt6(r)
            r[rng.integers(0, L)] = rng.integers(1, 5)
        elif kind == 4:
            r = rng.integers(1, 5, L).astype(np.uint8)
        elif kind == 5:
            r[rng.integers(0, L)] = 5
        out.append(r)
    return out + [enc[:5].copy(), enc[-7:].copy(),
                  rng.integers(1, 5, 3).astype(np.uint8),
                  enc[100:101].copy(), enc[200:700].copy()]


ANCHOR_FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


def lane_edge_case(seed: int = 5):
    """(genome, cmax, reads) aimed at the anchor lane machine's key and
    compare steps: a 20 kb genome (random, a 400 bp unit 12 times, random)
    whose tables take cmax 4, so the unit's k-mers go to the host; and nt6
    reads that give verify rounds of 0, 1 and 128 symbols, a mismatch at
    the last symbol of a 128-symbol round, matches that run to a row's end
    and continue, compares that run into the end of the two-strand text,
    an N in a key window, keys above cmax, and reads of 63-193 symbols on
    both strands, whose rows cross the 64-symbol stride.
    tests/test_torch_anchor_lanes.py shows that each of these is reached."""
    from svdss_tpu_torch.ops.anchor import pick_k
    from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_nt6
    rng = np.random.default_rng(seed)

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    head, unit = rand(9_000), rand(400)
    g = head + unit * 12 + rand(6_200)
    # a 200 bp piece S twice: at P1, and at P2 behind another symbol
    P1, P2 = 7_000, 14_588
    g = g[:P2] + g[P1:P1 + 200] + g[P2 + 200:]
    if g[P1 - 1] == g[P2 - 1]:
        g = g[:P1 - 1] + "ACGT"["CGTA".index(g[P1 - 1])] + g[P1:]
    G = len(g)
    enc = encode_nt6(g)
    k = pick_k(2 * G + 2)

    def snv(r, at):
        r = r.copy()
        r[at] = r[at] % 4 + 1
        return r
    reads = []
    # verify rounds of lim = maxlen - k = 0 and 1: reads of k and k + 1
    # symbols, on both strands
    for m in (k, k + 1):
        r = enc[2_000:2_000 + m].copy()
        reads += [r, revcomp_nt6(r)]
    # exact 600-symbol reads at 64 start phases: the backward phase
    # verifies the whole read on the reverse strand; at the phase where
    # text and read rows line up (s = 2G + 1 mod 64) its rounds after the
    # first compare 128 symbols each, and every phase runs to a row's end
    # and continues
    L = 600
    reads += [enc[s:s + L].copy() for s in range(500, 500 + 65 * 64, 65)]
    # that aligned read with an SNV where the second verify round compares
    # its 128th symbol (read position L - 256 + (-L mod 64))
    s = 500 + (2 * G + 1 - 500) % 64
    reads.append(snv(enc[s:s + L], L - 256 + (-L) % 64))
    # compares that reach the text's end ($ at n - 1, zeros past n): the
    # reverse strand of a read that begins at the chromosome's start;
    # and the chromosome's end on the forward strand
    x = encode_nt6(rand(100))
    reads += [np.concatenate([x, enc[:300]]),
              np.concatenate([enc[G - 300:], x])]
    # an N in the first key window (the read's last k symbols)
    reads.append(enc[3_000:3_200].copy())
    reads[-1][-3] = 5
    # keys above cmax: reads inside the repeated unit
    reads += [enc[9_100:9_400].copy(), revcomp_nt6(enc[10_000:10_300])]
    # rows that cross the 64-symbol stride, on both strands, with SNVs
    for m in (63, 64, 65, 127, 128, 129, 191, 192, 193):
        r = snv(snv(enc[4_000 + 7 * m:4_000 + 8 * m].copy(), m // 3),
                2 * m // 3)
        reads += [r, revcomp_nt6(r)]
    # a long forward verify: c + S + W, where S + W occurs only at P1 and
    # c + S only at P2, so the backward phase stops at c and the forward
    # phase from c verifies S, past a row's end; P2 - 60 is a multiple of
    # 64, so its second round compares 128 symbols
    r = np.concatenate([enc[P2 - 60:P2 + 200], enc[P1 + 200:P1 + 300]])
    reads += [r, revcomp_nt6(r)]
    # a chimera of two distant pieces, both strands
    r = np.concatenate([enc[5_000:5_200], enc[16_000:16_250]])
    reads += [r, revcomp_nt6(r)]
    return g, 4, reads


WIDE_EDGE_K = 10


def wide_edge_case(seed: int = 6):
    """(nt6 text, {name: build kwargs}, nt6 reads) aimed at the wide anchor
    lane machine's key and compare steps (kernel K5: 512-symbol rows at
    stride 256): a 24 kb genome (random, a 400 bp unit 12 times, random,
    two 700 bp segments each copied twice with an SNV near one copy's end)
    with k = 10 tables sorted, right-order-only, unsorted, and heavy (cmax
    4, so the unit's k-mers park). The reads give compares of 0, 1 and 512
    symbols and a mismatch at the 512th; leftward runs into the text start
    (re-scanned at 512 or fewer available symbols, and not); pair-verify
    rounds whose first candidate fails and second survives; rows across
    the 256-symbol stride on both sides; key windows cut at a row's edge.
    tests/test_torch_anchor_wide_lanes.py shows that each is reached."""
    from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_nt6
    rng = np.random.default_rng(seed)
    k = WIDE_EDGE_K

    def rand(n):
        return encode_nt6("".join("ACGT"[i] for i in rng.integers(0, 4, n)))

    def snv(r, at):
        r = r.copy()
        r[at] = r[at] % 4 + 1
        return r
    unit = rand(400)
    X, Y = rand(700), rand(700)
    parts = [rand(9_216), np.tile(unit, 12), rand(3_000), X, rand(500),
             snv(Y, 700 - k - 20), rand(500), snv(X, 700 - k - 20),
             rand(500), Y, rand(2_000)]
    text = np.concatenate(parts).astype(np.uint8)
    reads = []
    # compares of D = maxlen - k = 0 and 1 symbols, both strands
    for m in (k, k + 1):
        r = text[2_000:2_000 + m].copy()
        reads += [r, revcomp_nt6(r)]
    # exact reads from a multiple of 256 of length 1,024 + k: orientation
    # B's leftward verify from the read's end starts at row column 511 of
    # both rows and compares 512 symbols, twice; with an SNV at read
    # position 512, the first compare's 512th symbol mismatches
    for s in (1_024, 4_096):
        r = text[s:s + 1_024 + k].copy()
        reads += [r, snv(r, 512), revcomp_nt6(r)]
    # leftward runs into the text start: reads that begin at or near it,
    # behind 0-40 random symbols
    for pre, s, n in ((0, 0, 700), (5, 0, 400), (40, 3, 600), (0, 100, 450),
                      (0, 255, 800), (17, 511, 900), (0, 300, 300)):
        reads.append(np.concatenate([rand(pre), text[s:s + n]]))
    # pair verifies: the duplicated segments (the copy with the SNV first
    # for X, second for Y), whole and in part, both strands
    x0 = len(np.concatenate(parts[:3]))
    y1 = x0 + 700 + 500
    for s0 in (x0 + len(np.concatenate(parts[3:7])), x0, y1,
               y1 + 700 + 500 + 700 + 500 + 700 + 500):
        r = text[s0:s0 + 700].copy()
        reads += [r, revcomp_nt6(r), r[200:].copy()]
    # rows across the 256-symbol stride, both strands, with SNVs
    for m in (255, 256, 257, 511, 512, 513, 767, 769):
        r = snv(snv(text[6_000 + m:6_000 + 2 * m].copy(), m // 3),
                2 * m // 3)
        reads += [r, revcomp_nt6(r)]
    # reads inside the repeated unit (heavy at cmax 4), both strands
    reads += [text[9_300:9_900].copy(), revcomp_nt6(text[10_000:10_500])]
    # a chimera of two distant pieces, both strands
    r = np.concatenate([text[5_000:5_300], text[21_000:21_400]])
    reads += [r, revcomp_nt6(r)]
    builds = {"sorted": dict(k=k, cmax=32),
              "right_only": dict(k=k, cmax=32, sort_buckets="right"),
              "unsorted": dict(k=k, cmax=32, sort_buckets=False),
              "heavy": dict(k=k, cmax=4)}
    return text, builds, reads


def lane_edge_budget(n: int) -> np.ndarray:
    """Per-lane round budgets of 3-60 for lane_edge_case's n reads: some
    lanes finish within theirs, the others are cut."""
    return np.random.default_rng(8).integers(3, 61, n).astype(np.int32)


def pool_flags(res) -> torch.Tensor:
    """K4's flags of a K3 result run under the pool's per-read budget."""
    from svdss_tpu_torch.ops.anchor_pool import FALLBACK, OVERFLOW
    return (res.incomplete.to(torch.uint8) * FALLBACK
            | res.overflow.to(torch.uint8) * OVERFLOW)


def check_anchor(rng) -> list:
    """K3 and K4 against their plain versions (all fields and the work
    counts), K4 against K3 under the same per-lane budget, and 64
    complete K3 lanes against the host oracle."""
    from svdss_tpu_torch.index.fmd import build_index, genome_text
    from svdss_tpu_torch.ops import anchor_device, anchor_pool
    from svdss_tpu_torch.ops.anchor import build_anchor_index
    from svdss_tpu_torch.ops.pingpong import pack_reads
    from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
    from svdss_tpu_torch.pipeline.search import _bucket_len
    from svdss_tpu_torch.utils.seq import encode_nt6

    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 1_000_000))
    chroms = {"g": g}
    dev, params = anchor_device.build_device_anchor(
        build_anchor_index(genome_text(chroms)), "cuda")
    enc = anchor_mix(encode_nt6(g), rng) + [
        encode_nt6(r) for r in long_reads(g, rng, 512)]
    L = _bucket_len(max(len(e) for e in enc))
    cap = max(128, L // 16)             # the one-shot search stage's cap
    # a repeat-rich genome (a 400 bp unit 200 times in 200 kb of random
    # sequence) with cmax 4: heavy k-mers send lanes to the host
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    rg = unit * 200 + "".join("ACGT"[i] for i in rng.integers(0, 4,
                                                              200_000))
    rdev, rparams = anchor_device.build_device_anchor(
        build_anchor_index(genome_text({"r": rg}), cmax=4), "cuda")
    renc = anchor_mix(encode_nt6(rg), rng, n=96, L=2000)
    cases = []

    def compare(name, d, p, encs, **kw):
        seqs, lens = pack_reads(encs, pad_to=L, device="cuda")
        work = torch.zeros(4, dtype=torch.int64, device="cuda")
        before = anchor_device.launches
        got = anchor_device.batch_search_anchor(d, p, seqs, lens, work=work,
                                                **kw)
        torch.cuda.synchronize()
        if anchor_device.launches != before + 1:
            raise RuntimeError("batch_search_anchor did not launch K3")
        plain_work = torch.zeros_like(work)
        want = anchor_device.batch_search_anchor_plain(
            d, p, seqs, lens, kw["cap"], kw.get("max_rounds")
            or anchor_device.default_max_rounds(L + 1),
            kw.get("overlap", -1), kw.get("budget"), plain_work)
        err = max_abs_diff([getattr(got, f) for f in ANCHOR_FIELDS]
                           + [work], [getattr(want, f) for f in
                                      ANCHOR_FIELDS] + [plain_work])
        cases.append({"case": name, "lanes": len(encs), "L": L,
                      "cap": kw["cap"], "max_abs_err": err,
                      "overflow": int(got.overflow.sum()),
                      "incomplete": int(got.incomplete.sum()),
                      "iters": int(got.iters),
                      "work": dict(zip(anchor_device.WORK_FIELDS,
                                       work.tolist()))})
        return got

    res = compare("anchor mix + 512 long reads", dev, params, enc, cap=cap)
    compare("cap=2 overflow", dev, params, enc[:64], cap=2)
    compare("max_rounds=200 incomplete", dev, params, enc[:64], cap=cap,
            max_rounds=200)
    compare("overlap=0", dev, params, enc[:64], cap=cap, overlap=0)
    compare("repeats, cmax=4", rdev, rparams, renc, cap=cap)
    if not cases[-1]["incomplete"]:
        raise RuntimeError("the heavy-k-mer case sent no lane to the host")

    # 64 complete lanes against the host oracle: the shortest ones
    index = build_index(chroms)
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

    # K4 on a stream longer than its lanes, mixed lengths, with 1, 33 and
    # 4,096 reads in flight: each against its plain version, against K3
    # under the same per-lane budget and against the first; and on the
    # lane-edge reads (K4's lanes read the reads unpadded)
    pool_cases = []

    def pool_compare(name, d, p, encs, lanes_list):
        syms, offs, lens = (torch.from_numpy(a).cuda() for a in
                            anchor_pool.pack_chunk(encs))
        plain_work = torch.zeros(4, dtype=torch.int64, device="cuda")
        want = anchor_pool.pool_search_plain(d, p, syms, offs, lens, L + 1,
                                             cap, -1, plain_work)
        seqs, lens3 = pack_reads(encs, pad_to=L, device="cuda")
        k3 = anchor_device.batch_search_anchor(
            d, p, seqs, lens3, cap=cap,
            budget=anchor_pool.lane_budget(lens3).to(torch.int32))
        flags3 = pool_flags(k3)
        first = None
        for lanes in lanes_list:
            work = torch.zeros(4, dtype=torch.int64, device="cuda")
            before = anchor_pool.launches
            got = anchor_pool.pool_search(d, p, syms, offs, lens, Lp1=L + 1,
                                          cap=cap, lanes=lanes, work=work)
            torch.cuda.synchronize()
            if anchor_pool.launches != before + 1:
                raise RuntimeError("pool_search did not launch K4")
            first = first or got
            pool_cases.append({
                "case": f"{name}: {len(encs)} reads, {lanes} lanes",
                "L": L, "cap": cap,
                "max_abs_err": max_abs_diff(list(got) + [work],
                                            list(want) + [plain_work]),
                "vs_one_shot_same_budget_max_abs_err": max_abs_diff(
                    list(got), [k3.qs, k3.length, k3.n_sfs, flags3]),
                "vs_first_lanes_max_abs_err": max_abs_diff(list(got),
                                                           list(first)),
                "host_flags": int((got.flags != 0).sum()),
                "work": dict(zip(anchor_device.WORK_FIELDS,
                                 work.tolist()))})

    pool_compare("stream", dev, params, enc, (1, 33, 4096))

    # the lane machine's edges (lane_edge_case): verify rounds of 0, 1 and
    # 128 symbols, a mismatch at a round's 128th symbol, rounds that
    # continue, compares into the text's end, an N in a key window, keys
    # above cmax, rows across the 64-symbol stride on both strands; with
    # the overflow, overlap 0 and budget variants
    eg, ecmax, edge = lane_edge_case()
    edev, eparams = anchor_device.build_device_anchor(
        build_anchor_index(genome_text({"e": eg}), cmax=ecmax), "cuda")
    compare("lane edges", edev, eparams, edge, cap=cap)
    compare("lane edges, cap=2", edev, eparams, edge, cap=2)
    compare("lane edges, overlap=0", edev, eparams, edge, cap=cap,
            overlap=0)
    compare("lane edges, budgets of 3-60 rounds", edev, eparams, edge,
            cap=cap, budget=torch.from_numpy(
                lane_edge_budget(len(edge))).cuda())
    if not cases[-1]["incomplete"]:
        raise RuntimeError("the budget case cut no lane")
    pool_compare("lane edges", edev, eparams, edge, (33,))

    errs4 = [max(c["max_abs_err"], c["vs_one_shot_same_budget_max_abs_err"],
                 c["vs_first_lanes_max_abs_err"]) for c in pool_cases]
    bad3 = sum(c["max_abs_err"] > 0 for c in cases) + oracle_bad
    return [{"name": "anchor_batch", "cases": cases,
             "oracle_lanes": len(order), "oracle_mismatches": oracle_bad,
             "mismatches": bad3,
             "max_abs_err": max(c["max_abs_err"] for c in cases)},
            {"name": "anchor_pool", "cases": pool_cases,
             "mismatches": sum(e > 0 for e in errs4),
             "max_abs_err": max(errs4)}]


PP_FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


def check_pingpong_wide(rng) -> dict:
    """K2's wide instantiation against its plain version in all six fields,
    at limb width 31 (the default; the high limbs are 0 below 2^31
    symbols) and 17 (on this 2M-symbol index the high limbs are not 0),
    on the read mix of check_pingpong with the overflow and step-budget
    cases; and against narrow K2 on the same reads. At limb width 31 the
    whole mix is held against narrow K2 alone (the timing phase holds it
    against the plain version at the main path's inputs)."""
    from svdss_tpu_torch.index.fmd import build_index
    from svdss_tpu_torch.ops import pingpong
    from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
    from svdss_tpu_torch.pipeline.search import _bucket_len
    from svdss_tpu_torch.utils.seq import encode_nt6

    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 1_000_000))
    index = build_index({"g": g})
    enc = [encode_nt6(r) for r in read_mix(g, rng) + long_reads(g, rng, 512)]
    L = _bucket_len(max(len(e) for e in enc))
    cap = max(128, L // 16)
    seqs, lens = pingpong.pack_reads(enc, pad_to=L, device="cuda")
    narrow = pingpong.batch_search(DeviceFMDIndex.from_host(index, "cuda"),
                                   seqs, lens, cap=cap)
    cases = []
    for limb in (31, 17):
        wide = DeviceFMDIndex.from_host(index, "cuda", force_wide=True,
                                        limb_bits=limb)
        high = bool((wide.fused[:, 6:8] != 0).any())
        if high != (limb < 31):
            raise RuntimeError(f"limb width {limb}: high limbs set = {high}")
        for name, n, whole, kw in (
                ("read mix + 512 long reads", len(enc), True, dict(cap=cap)),
                ("cap=2 overflow", 64, False, dict(cap=2)),
                ("max_iters=200 incomplete", 64, False,
                 dict(cap=cap, max_iters=200))):
            before = pingpong.launches
            got = pingpong.batch_search(wide, seqs[:n], lens[:n], **kw)
            torch.cuda.synchronize()
            if pingpong.launches != before + 1:
                raise RuntimeError("batch_search did not launch K2 (wide)")
            case = {"case": f"limb {limb}: {name}", "lanes": n, "L": L,
                    "cap": kw["cap"], "max_abs_err": 0,
                    "overflow": int(got.overflow.sum()),
                    "incomplete": int(got.incomplete.sum()),
                    "iters": int(got.iters)}
            if limb < 31 or not whole:
                max_iters = kw.get("max_iters") or 8 * L + 64
                want = pingpong.batch_search_plain(
                    wide, seqs[:n], lens[:n], kw["cap"],
                    -(-max_iters // pingpong.K_INNER))
                case["max_abs_err"] = max_abs_diff(
                    [getattr(got, f) for f in PP_FIELDS],
                    [getattr(want, f) for f in PP_FIELDS])
            else:
                case["plain"] = "timing phase"
            if whole:
                case["vs_narrow_max_abs_err"] = max_abs_diff(
                    [getattr(got, f) for f in PP_FIELDS],
                    [getattr(narrow, f) for f in PP_FIELDS])
            cases.append(case)
    errs = [max(c["max_abs_err"], c.get("vs_narrow_max_abs_err", 0))
            for c in cases]
    return {"name": "pingpong_fm_wide", "cases": cases,
            "mismatches": sum(e > 0 for e in errs), "max_abs_err": max(errs)}


def check_pingpong_edges() -> list:
    """K2 on the reads of pingpong_edge_case (spans ending at 256 symbols
    and one past, pending steps, sentinel steps, safe_b's edge) against its
    plain version in all six fields, at cap 64 (some lanes overflow) and
    under a 200-step budget: narrow, wide at limb widths 12 (low limbs
    carry past 2^12) and 31, and jump mode at k = 4 and 6 with tables
    built by K6 on the card. K6 itself at k = 1, 4, 6 and 8 on that genome,
    whose 8-mers are mostly absent, against its plain version."""
    from svdss_tpu_torch.index.fmd import build_index
    from svdss_tpu_torch.ops import fmd, pingpong
    from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
    g, reads = pingpong_edge_case()
    index = build_index({"e": g})
    narrow = DeviceFMDIndex.from_host(index, "cuda")
    seqs, lens = pingpong.pack_reads(reads, device="cuda")
    Lp1 = seqs.shape[1]
    k6 = []
    tables = {}
    for k in (1, 4, CHECK_JUMP_K, 8):
        before = fmd.launches
        got = fmd.build_jump_table(narrow, k)
        torch.cuda.synchronize()
        if fmd.launches != before + k - 1:
            raise RuntimeError(f"build_jump_table({k}) launched K6 "
                               f"{fmd.launches - before} times, not {k - 1}")
        tables[k] = got
        k6.append({"case": f"edge genome k={k}", "rows": 4 ** k,
                   "present": int((got[:, 2] > 0).sum()),
                   "max_abs_err": max_abs_diff(
                       [got], [fmd.build_jump_table_plain(narrow, k)])})
    if k6[-1]["present"] * 2 > k6[-1]["rows"]:
        raise RuntimeError("the edge genome's 8-mers are mostly present")
    modes = {"narrow": (narrow, {}),
             "wide limb 12": (DeviceFMDIndex.from_host(
                 index, "cuda", force_wide=True, limb_bits=PP_EDGE_LIMB), {}),
             "wide limb 31": (DeviceFMDIndex.from_host(
                 index, "cuda", force_wide=True), {}),
             "jump k=4": (narrow, dict(jump_table=tables[4], jump_k=4)),
             f"jump k={CHECK_JUMP_K}": (narrow, dict(
                 jump_table=tables[CHECK_JUMP_K], jump_k=CHECK_JUMP_K))}
    cases = []
    for name, (tab, jkw) in modes.items():
        for budget in (0, 200):
            before = pingpong.launches
            got = pingpong.batch_search(tab, seqs, lens, cap=64,
                                        max_iters=budget, **jkw)
            torch.cuda.synchronize()
            if pingpong.launches != before + 1:
                raise RuntimeError(f"batch_search did not launch K2 ({name})")
            max_iters = budget or 8 * (Lp1 - 1) + 64
            want = pingpong.batch_search_plain(
                tab, seqs, lens, 64, -(-max_iters // pingpong.K_INNER),
                jump_table=jkw.get("jump_table"), jump_k=jkw.get("jump_k", 0))
            label = f", max_iters={budget}" if budget else ""
            cases.append({"case": f"edge reads, {name}{label}",
                          "lanes": len(reads), "L": Lp1 - 1, "cap": 64,
                          "max_abs_err": max_abs_diff(
                              [getattr(got, f) for f in PP_FIELDS],
                              [getattr(want, f) for f in PP_FIELDS]),
                          "overflow": int(got.overflow.sum()),
                          "incomplete": int(got.incomplete.sum()),
                          "iters": int(got.iters)})
    return [{"name": "pingpong_fm_edges", "cases": cases,
             "mismatches": sum(c["max_abs_err"] > 0 for c in cases),
             "max_abs_err": max(c["max_abs_err"] for c in cases)},
            {"name": "jump_level_edges", "cases": k6,
             "mismatches": sum(c["max_abs_err"] > 0 for c in k6),
             "max_abs_err": max(c["max_abs_err"] for c in k6)}]


def repeat_genome(rng, copies: int, unit_len: int = 600,
                  spacer: int = 800) -> str:
    """5%-diverged copies of one unit between random spacers, after 3 kb of
    random sequence (the genome of the JAX package's parked-wave tests)."""
    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    unit = rand(unit_len)
    parts = [rand(3_000)]
    for _ in range(copies):
        c = list(unit)
        for _ in range(unit_len // 20):
            c[int(rng.integers(0, unit_len))] = "ACGT"[int(rng.integers(0,
                                                                     4))]
        parts += ["".join(c), rand(spacer)]
    return "".join(parts)


class Asked:
    """A resolve_phases callback answering from the heavy store, keeping
    every wave's parked lanes, anchors and directions."""

    def __init__(self, resolver, encs):
        self.resolver, self.encs, self.calls = resolver, encs, []

    def __call__(self, lanes, ancs, dirbs):
        self.calls.append((lanes.tolist(), ancs.tolist(), dirbs.tolist()))
        return np.array([self.resolver(self.encs[int(ln)], int(a),
                                       "left" if d == 1 else "right")
                         for ln, a, d in zip(lanes, ancs, dirbs)],
                        dtype=np.int32)


def plain_wave_run(aw):
    """The wave driver over K5's plain version on the card (the wrapper
    takes the plain version only for CPU tensors)."""
    class PlainWaves(aw.WideWaveRun):
        def _wave(self, r0):
            if self.chunks is None:
                self.chunks = aw.read_chunks(self.seqs, self.lens)
            aw.run_wave_plain(self.index, self.params, self.chunks,
                              self.lens, self.state, self.out_qs, self.out_l,
                              self.rounds, r0, self.cap, self.max_rounds,
                              self.overlap, True, self.work)
    return PlainWaves


def snv_read(enc: np.ndarray, rng, rate: float = 0.001) -> np.ndarray:
    """A copy of an nt6 piece with SNVs at `rate`."""
    r = enc.copy()
    at = rng.random(len(r)) < rate
    r[at] = r[at] % 4 + 1
    return r


def check_anchor_wide(rng) -> dict:
    """K5 against its plain version in all six fields and its four work
    counts: one shot on the wide table variants over a 1 Mbp genome (fused
    8|8 counts with uint8 lperm, right-order-only, 16|16 with uint16
    lperm, unsorted buckets; N reads, overlap 0, cap 2, a small round
    budget) and on a repeat-rich genome whose heavy anchors send lanes to
    the host; and in parked-phase waves (the same waves asked of the heavy
    store, park_limit 16 and 1, right-order-only), which must park lanes;
    and on the reads of wide_edge_case, aimed at the warp's key and compare
    steps, on its four table builds (one shot with the default, cap 2,
    overlap 0 and 40 rounds; in waves on the heavy build); and two reads
    of 240,000 symbols, too wide for the packed lanes. 64 complete lanes
    against the host oracle."""
    from svdss_tpu_torch.index.fmd import build_index
    from svdss_tpu_torch.ops import anchor_wide_device as aw
    from svdss_tpu_torch.ops.anchor_wide import (build_anchor_index_wide,
                                                 make_heavy_resolver)
    from svdss_tpu_torch.ops.pingpong import pack_reads
    from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
    from svdss_tpu_torch.pipeline.search import _bucket_len
    from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_nt6

    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 1_000_000))
    fwd = encode_nt6(g)
    enc = anchor_mix(fwd, rng) + [encode_nt6(r)
                                  for r in long_reads(g, rng, 512)]
    L = _bucket_len(max(len(e) for e in enc))
    cap = max(128, L // 16)
    seqs, lens = pack_reads(enc, pad_to=L, device="cuda")
    rg = repeat_genome(rng, copies=200)
    renc = anchor_mix(encode_nt6(rg), rng, n=96, L=2000)
    rseqs, rlens = pack_reads(renc, device="cuda")

    def tables(text, **build):
        widx = build_anchor_index_wide(text, **build)
        return widx, aw.build_device_anchor_wide(widx, "cuda")
    sorted32 = tables(fwd.copy(), cmax=32)
    cases = []

    def one_shot(name, tab, s, ln, **kw):
        _, (d, p) = tab
        work = torch.zeros(4, dtype=torch.int64, device="cuda")
        before = aw.launches
        got = aw.batch_search_anchor_wide(d, p, s, ln, work=work, **kw)
        torch.cuda.synchronize()
        if aw.launches != before + 1:
            raise RuntimeError("batch_search_anchor_wide did not launch K5")
        state = aw.reset_state(s, ln)
        oq = torch.zeros((s.shape[0], kw["cap"]), dtype=torch.int32,
                         device="cuda")
        ol, rounds = torch.zeros_like(oq), torch.zeros(
            1, dtype=torch.int32, device="cuda")
        plain_work = torch.zeros_like(work)
        aw.run_wave_plain(d, p, aw.read_chunks(s, ln), ln, state, oq, ol,
                          rounds, 0, kw["cap"], kw.get("max_rounds")
                          or aw.default_max_rounds(s.shape[1]),
                          kw.get("overlap", -1), False, plain_work)
        want = aw.result_of(state, oq, ol, rounds)
        cases.append({"case": name, "form": "one shot", "lanes": len(ln),
                      "L+1": s.shape[1], "cap": kw["cap"],
                      "max_abs_err": max_abs_diff(
                          [getattr(got, f) for f in ANCHOR_FIELDS] + [work],
                          [getattr(want, f) for f in ANCHOR_FIELDS]
                          + [plain_work]),
                      "overflow": int(got.overflow.sum()),
                      "incomplete": int(got.incomplete.sum()),
                      "iters": int(got.iters),
                      "work": dict(zip(aw.WORK_FIELDS, work.tolist()))})
        return got

    def waves(name, tab, s, ln, encs, park_limit=16):
        widx, (d, p) = tab
        runs = []
        for driver in (aw.WideWaveRun, plain_wave_run(aw)):
            asked = Asked(make_heavy_resolver(widx), encs)
            work = torch.zeros(4, dtype=torch.int64, device="cuda")
            before = aw.launches
            run = driver(d, p, s, ln, asked, cap=cap, park_limit=park_limit,
                         work=work)
            res = run.finish()
            torch.cuda.synchronize()
            runs.append((res, work, asked, run, aw.launches - before))
        (got, work, asked, run, n_launch), (want, pwork, pasked, prun, _) = \
            runs
        if n_launch < len(asked.calls) + 1:
            raise RuntimeError(f"{name}: {n_launch} K5 launches for "
                               f"{len(asked.calls)} resolved waves")
        err = max_abs_diff([getattr(got, f) for f in ANCHOR_FIELDS] + [work],
                           [getattr(want, f) for f in ANCHOR_FIELDS]
                           + [pwork])
        if asked.calls != pasked.calls or run.n_waves != prun.n_waves:
            err = max(err, 1)
        cases.append({"case": name, "form": "waves", "lanes": len(ln),
                      "L+1": s.shape[1], "cap": cap, "max_abs_err": err,
                      "waves": run.n_waves, "parked_lanes": run.parked_lanes,
                      "overflow": int(got.overflow.sum()),
                      "incomplete": int(got.incomplete.sum()),
                      "iters": int(got.iters),
                      "work": dict(zip(aw.WORK_FIELDS, work.tolist()))})
        return got

    res = one_shot("sorted 8|8, anchor mix + 512 long reads", sorted32,
                   seqs, lens, cap=cap)
    one_shot("cap=2 overflow", sorted32, seqs[:64], lens[:64], cap=2)
    one_shot("max_rounds=200 incomplete", sorted32, seqs[:64], lens[:64],
             cap=cap, max_rounds=200)
    one_shot("overlap=0", sorted32, seqs[:64], lens[:64], cap=cap, overlap=0)
    for name, build in (("right-order-only", dict(cmax=32,
                                                  sort_buckets="right")),
                        ("16|16, uint16 lperm (cmax 2000)", dict(cmax=2000)),
                        ("unsorted buckets", dict(cmax=32,
                                                  sort_buckets=False))):
        one_shot(name, tables(fwd.copy(), **build), seqs[:128], lens[:128],
                 cap=cap)
    waves("clean genome", sorted32, seqs[:64], lens[:64], enc)
    rsorted = tables(encode_nt6(rg), k=10, cmax=12)
    one_shot("repeats, cmax 12", rsorted, rseqs, rlens, cap=cap)
    if not cases[-1]["incomplete"]:
        raise RuntimeError("the heavy-k-mer case sent no lane to the host")
    waves("repeats, cmax 12", rsorted, rseqs, rlens, renc)
    waves("repeats, park_limit 1", rsorted, rseqs, rlens, renc, park_limit=1)
    waves("repeats, right-order-only",
          tables(encode_nt6(rg), k=10, cmax=12, sort_buckets="right"),
          rseqs, rlens, renc)
    parked = [c for c in cases if c["form"] == "waves"
              and c["case"].startswith("repeats")]
    if not all(c["waves"] >= 1 and c["parked_lanes"] >= 1 for c in parked):
        raise RuntimeError("the repeat genome parked no lane")
    # the edge reads of wide_edge_case on each of its builds, one shot
    # (default, cap 2, overlap 0, 40 rounds), and in waves on its heavy
    # build
    etext, ebuilds, ereads = wide_edge_case()
    eseqs, elens = pack_reads(ereads, device="cuda")
    for bname, build in ebuilds.items():
        etab = tables(etext.copy(), **build)
        for cname, kw in (("", {}), (", cap 2", dict(cap=2)),
                          (", overlap 0", dict(overlap=0)),
                          (", 40 rounds", dict(max_rounds=40))):
            one_shot(f"edge reads, {bname}{cname}", etab, eseqs, elens,
                     **dict(dict(cap=128), **kw))
        if bname == "heavy":
            for limit in (16, 1):
                waves(f"edge reads, heavy, park_limit {limit}", etab, eseqs,
                      elens, ereads, park_limit=limit)
    # reads of 240,000 symbols with SNVs, both strands: four packed reads
    # of this width pass the shared memory a block may opt in to, so the
    # launch takes the lanes that read the read's bytes
    long = snv_read(fwd[100_000:340_000], rng)
    lseqs, llens = pack_reads([long, revcomp_nt6(long)], device="cuda")
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", 232_448)
    if 4 * 4 * -(-lseqs.shape[1] // 16) <= optin:
        raise RuntimeError("the long reads fit the packed lanes' memory")
    one_shot("240 kb reads (byte-reading lanes)", sorted32, lseqs, llens,
             cap=cap)

    # 64 complete lanes of the first case against the host oracle
    index = build_index({"g": g})
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
    return {"name": "anchor_wide", "cases": cases,
            "oracle_lanes": len(order), "oracle_mismatches": oracle_bad,
            "mismatches": sum(c["max_abs_err"] > 0 for c in cases)
            + oracle_bad,
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


# K1's edge shapes, (pairs, lq, lt, kind) by name: the width W = lq + 1
# at 1, around a warp, around each width where the cells a thread change
# (1,024, 2,048, 3,072) and at the register path's last width (5,120) and
# the first past it; lt below lq and lt = 1; the target cell at the last
# diagonal and at 0; all mismatches (NEG drifts through invalid cells);
# one pair. tests/test_torch_wavefront_lanes.py runs them too.
DP_EDGE_CASES = {
    "W1": (3, 0, 5, "random"),
    "W31": (2, 30, 9, "random"),
    "W32": (2, 31, 12, "random"),
    "W33": (2, 32, 4, "random"),
    "W1023_lt1": (1, 1022, 1, "random"),
    "W1024": (2, 1023, 3, "random"),
    "W1025": (1, 1024, 2, "random"),
    "W2048": (1, 2047, 2, "random"),
    "W2049": (1, 2048, 1, "random"),
    "W3072": (1, 3071, 1, "random"),
    "W3073": (1, 3072, 1, "random"),
    "W5120": (1, 5119, 1, "random"),
    "W5121": (1, 5120, 1, "random"),
    "lt_below_lq": (3, 90, 40, "random"),
    "lt_above_lq": (3, 40, 90, "random"),
    "tgt_last": (2, 70, 60, "tgt_last"),
    "tgt_zero": (2, 70, 60, "tgt_zero"),
    "all_mismatch": (2, 80, 50, "mismatch"),
    "one_pair": (1, 200, 150, "random"),
}


def dp_edge_case(name: str):
    """numpy (q, t, tgt_d, tgt_i, lq, lt) of one DP_EDGE_CASES entry, from a
    seed of its own: pairs padded to (lq, lt) as the call stage pads them
    (-3 / -4), pair 0 filling the bucket and the others ragged."""
    B, lq, lt, kind = DP_EDGE_CASES[name]
    rng = np.random.default_rng(sorted(DP_EDGE_CASES).index(name))
    q = np.full((B, lq), -3, np.int32)
    t = np.full((B, lt), -4, np.int32)
    nq = rng.integers(0, lq + 1, B)
    nt = rng.integers(1, lt + 1, B)
    nq[0], nt[0] = lq, lt
    for b in range(B):
        tb = rng.integers(1, 5, nt[b])
        qb = tb[:nq[b]].copy() if nq[b] <= nt[b] else np.concatenate(
            [tb, rng.integers(1, 5, nq[b] - nt[b])])
        snv = rng.random(len(qb)) < 0.05
        qb[snv] = rng.integers(1, 5, int(snv.sum()))
        if kind == "mismatch":
            qb[:], tb[:] = 1, 2
        q[b, :nq[b]], t[b, :nt[b]] = qb, tb
    tgt_d = (nq + nt).astype(np.int32)
    tgt_i = nq.astype(np.int32)
    if kind == "tgt_last":
        tgt_d[:], tgt_i[:] = lq + lt, lq
    elif kind == "tgt_zero":
        tgt_d[:] = 0
    return q, t, tgt_d, tgt_i, lq, lt


def check_wavefront(rng) -> dict:
    """K1 against its plain version over the whole trace and the scores at
    the call stage's buckets (CIGARs of a sample against the host DP) and
    at DP_EDGE_CASES."""
    from svdss_tpu_torch.ops import align_dp
    from svdss_tpu_torch.ops.align import align_dual_gap
    from svdss_tpu_torch.pipeline.call import _CALL_PARAMS

    cases = []
    cigar_checked = cigar_bad = 0
    # the call stage's power-of-two buckets, each at its chunk size
    # (pipeline/call.py pcall); 8192 x 512 (W = 8,193) runs past the
    # register path, with the DP state in global scratch
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
                      "global_scratch": align_dp.scratch_words(bq) > 0})
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
    for name in sorted(DP_EDGE_CASES):
        q, t, td, ti, lq, lt = dp_edge_case(name)
        args = [torch.from_numpy(a).cuda() for a in (q, t, td, ti)]
        before = align_dp.launches
        got = align_dp.wavefront(*args, lq, lt, _CALL_PARAMS)
        torch.cuda.synchronize()
        if align_dp.launches != before + 1:
            raise RuntimeError("wavefront did not launch the kernel")
        want = align_dp.wavefront_plain(*args, lq, lt, _CALL_PARAMS)
        cases.append({"case": name, "pairs": len(q),
                      "max_abs_err": max_abs_diff(got, want),
                      "global_scratch": align_dp.scratch_words(lq) > 0})
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
    checks = [*check_pingpong(rng), check_pingpong_wide(rng),
              *check_pingpong_edges(), *check_anchor(rng),
              check_anchor_wide(rng), check_wavefront(rng)]
    emit({"phase": "kernels", "seconds": round(time.time() - t0, 3),
          "tolerance": 0, "checks": checks})
    bad = [c["name"] for c in checks if c["mismatches"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    errs = {c["name"]: c["max_abs_err"] for c in checks}
    # K2's two instantiations and its jump mode are one kernel's
    errs["pingpong_fm"] = max(errs["pingpong_fm"],
                              errs.pop("pingpong_fm_wide"),
                              errs.pop("pingpong_fm_jump"),
                              errs.pop("pingpong_fm_edges"))
    errs["jump_level"] = max(errs["jump_level"],
                             errs.pop("jump_level_edges"))
    return errs


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


# the stage functions `cli run` calls (it imports each from its module at
# call time, or calls it through its module's globals), so replacing the
# module's attribute times the stage; the anchor tables' build, load and
# device upload are entries of their own (the upload inside search)
STAGES = (("index", "svdss_tpu_torch.index.fmd", "build_index"),
          ("anchor_build", "svdss_tpu_torch.cli", "_build_anchor"),
          ("smooth", "svdss_tpu_torch.pipeline.smooth", "run_smooth"),
          ("anchor_load", "svdss_tpu_torch.cli", "_load_anchor"),
          ("search", "svdss_tpu_torch.pipeline.search", "run_search"),
          ("anchor_upload", "svdss_tpu_torch.pipeline.search",
           "build_device_anchor"),
          ("anchor_upload", "svdss_tpu_torch.pipeline.search",
           "build_device_anchor_wide"),
          ("call", "svdss_tpu_torch.pipeline.call", "run_call"))

# each kernel's launch counter (a module-level `launches`)
KERNEL_MODULES = {"wavefront_dp": "svdss_tpu_torch.ops.align_dp",
                  "pingpong_fm": "svdss_tpu_torch.ops.pingpong",
                  "jump_level": "svdss_tpu_torch.ops.fmd",
                  "anchor_batch": "svdss_tpu_torch.ops.anchor_device",
                  "anchor_pool": "svdss_tpu_torch.ops.anchor_pool",
                  "anchor_wide": "svdss_tpu_torch.ops.anchor_wide_device"}


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


def run_cli(argv: list, required: tuple, kmer_jump: int = 0) -> dict:
    """One `cli run`, with every kernel's launch count set to 0 just
    before it and read just after, its stages timed and its log kept.
    `kmer_jump` sets Config.kmer_jump, which has no flag (as in the JAX
    package's command line): run_search and run_call get the config `run`
    makes with it set."""
    from svdss_tpu_torch import cli
    from svdss_tpu_torch.utils.log import logger
    mods = {k: importlib.import_module(m) for k, m in KERNEL_MODULES.items()}
    tap = LogTap()
    logger.addHandler(tap)
    timer = StageTimer()
    make_cfg = cli._cfg

    def cfg_with_jump(args):
        cfg = make_cfg(args)
        cfg.kmer_jump = kmer_jump
        return cfg
    cli._cfg = cfg_with_jump
    try:
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["run", *argv])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: mod.launches for k, mod in mods.items()}
    finally:
        cli._cfg = make_cfg
        timer.restore()
        logger.removeHandler(tap)
    if rc != 0:
        raise RuntimeError(f"run {argv} exited {rc}")
    stages = timer.stages(*required)
    # (the host engines' line has no redo count)
    m = tap.grab(r"search: (\d+) reads in .*?reads/s\)"
                 r"(?:, (\d+) host fallbacks)?")
    n_reads = int(m.group(1))
    return {"run_s": run_s, "stage_s": stages, "launches": launches,
            "search_reads": n_reads,
            "search_reads_per_s": n_reads / stages["search"],
            "host_redo_reads": int(m.group(2) or 0), "tap": tap}


def expect(run: dict, label: str, launched: tuple, idle: tuple,
           logged: tuple, absent: tuple = ()) -> None:
    """Fail unless each kernel in `launched` ran and none in `idle` did,
    and the log holds every pattern of `logged` and none of `absent`."""
    counts = run["launches"]
    never = [k for k in launched if counts[k] < 1]
    extra = [k for k in idle if counts[k] != 0]
    if never or extra:
        raise RuntimeError(f"{label}: kernels never launched {never}, "
                           f"launched though off the path {extra}: {counts}")
    for pat in logged:
        run["tap"].grab(pat)
    for pat in absent:
        if any(re.search(pat, line) for line in run["tap"].lines):
            raise RuntimeError(f"{label}: log shows {pat!r}")


def phase_run(wd: str, args) -> dict:
    from svdss_tpu_torch.ops import align_dp, anchor_pool
    from svdss_tpu_torch.ops import anchor_wide_device as aw
    from svdss_tpu_torch.pipeline import search as search_mod

    sim = simulate(wd, args.seed)
    ref, bam = os.path.join(wd, "ref.fa"), os.path.join(wd, "reads.bam")
    dirs = {k: os.path.join(wd, k) for k in ("auto", "oneshot", "fm",
                                              "host", "wide", "jump")}
    common = ["--reference", ref, "--bam", bam,
              "--threads", str(os.cpu_count() or 4)]

    spies = {"pingpong_fm": Spy(search_mod, "batch_search",
                                lambda idx, seqs, lens, **kw: (
                                    (tuple(seqs.shape), kw.get("cap"),
                                     kw.get("jump_k", 0)),
                                    seqs.numel())),
             "anchor_batch": Spy(search_mod, "batch_search_anchor",
                                 lambda idx, p, seqs, lens, **kw: (
                                     (tuple(seqs.shape), kw.get("cap")),
                                     seqs.numel())),
             "anchor_pool": Spy(anchor_pool, "pool_search",
                                lambda idx, p, syms, offs, lens, **kw: (
                                    (lens.shape[0], kw["Lp1"], kw["cap"]),
                                    syms.numel())),
             "anchor_wide": Spy(aw, "run_wave",
                                lambda idx, p, seqs, lens, *a, **kw: (
                                    (tuple(seqs.shape), a[5], a[8]),
                                    seqs.numel())),
             "wavefront_dp": Spy(align_dp, "wavefront",
                                 lambda q, t, td, ti, lq, lt, p=None: (
                                     (q.shape[0], lq, lt),
                                     q.shape[0] * (lq + lt) * lq))}
    runs = {}
    try:
        # the main path: the default engine choice, as a user runs it
        runs["auto"] = run_cli(
            [*common, "--workdir", dirs["auto"]],
            ("index", "anchor_build", "smooth", "anchor_load", "search",
             "anchor_upload", "call"))
        expect(runs["auto"], "auto run", ("anchor_pool", "wavefront_dp"),
               ("anchor_batch", "pingpong_fm", "anchor_wide"),
               (r"search: anchor engine on cuda",
                r"search: anchor pool on cuda"), (r"FM engine on",))
        # the other engines on hard links of the same index, anchor tables
        # and smoothed BAM: only search and call rerun
        for name in ("oneshot", "fm", "host"):
            os.makedirs(dirs[name])
            for f in ("index.fmd.npz", "index.fmd.npz.anchor.npz",
                      "smoothed.bam"):
                os.link(os.path.join(dirs["auto"], f),
                        os.path.join(dirs[name], f))
        runs["oneshot"] = run_cli(
            [*common, "--workdir", dirs["oneshot"], "--engine", "anchor",
             "--no-pool"], ("anchor_load", "search", "anchor_upload", "call"))
        expect(runs["oneshot"], "--no-pool run",
               ("anchor_batch", "wavefront_dp"),
               ("anchor_pool", "pingpong_fm", "anchor_wide"),
               (r"search: anchor engine on cuda",), (r"anchor pool on",))
        runs["fm"] = run_cli(
            [*common, "--workdir", dirs["fm"], "--engine", "fm"],
            ("search", "call"))
        expect(runs["fm"], "--engine fm run", ("pingpong_fm", "wavefront_dp"),
               ("anchor_batch", "anchor_pool", "anchor_wide"),
               (r"search: FM engine on cuda",))
        runs["host"] = run_cli(
            [*common, "--workdir", dirs["host"], "--no-device"],
            ("search", "call"))
        expect(runs["host"], "--no-device run", (), tuple(KERNEL_MODULES),
               ())
        # the JAX package's wide switch: wide forward-strand tables of its
        # own, on hard links of the index and smoothed BAM; at 80M symbols
        # the cost model takes the wide anchor engine, in waves (the
        # tables carry the heavy store)
        os.makedirs(dirs["wide"])
        for f in ("index.fmd.npz", "smoothed.bam"):
            os.link(os.path.join(dirs["auto"], f),
                    os.path.join(dirs["wide"], f))
        os.environ["SVDSS_TPU_WIDE_ANCHOR"] = "1"
        try:
            runs["wide"] = run_cli(
                [*common, "--workdir", dirs["wide"]],
                ("anchor_build", "anchor_load", "search", "anchor_upload",
                 "call"))
        finally:
            del os.environ["SVDSS_TPU_WIDE_ANCHOR"]
        expect(runs["wide"], "wide run", ("anchor_wide", "wavefront_dp"),
               ("pingpong_fm", "anchor_batch", "anchor_pool", "jump_level"),
               (r"index: WIDE anchor tables",
                r"search: wide anchor engine on cuda .*parked-phase waves"),
               (r"FM engine on", r"anchor pool on",
                r"cost model picks FM"))
        # the FM engine with the k-mer jump-start (Config.kmer_jump, no
        # flag), on hard links of the index and smoothed BAM
        os.makedirs(dirs["jump"])
        for f in ("index.fmd.npz", "smoothed.bam"):
            os.link(os.path.join(dirs["auto"], f),
                    os.path.join(dirs["jump"], f))
        runs["jump"] = run_cli(
            [*common, "--workdir", dirs["jump"], "--engine", "fm"],
            ("search", "call"), kmer_jump=RUN_JUMP_K)
        expect(runs["jump"], "kmer_jump run",
               ("jump_level", "pingpong_fm", "wavefront_dp"),
               ("anchor_batch", "anchor_pool", "anchor_wide"),
               (r"search: FM engine on cuda",
                rf"search: built {RUN_JUMP_K}-mer jump table in"))
        runs["jump"]["jump_table_log_s"] = float(runs["jump"]["tap"].grab(
            r"built \d+-mer jump table in ([\d.]+)s").group(1))
        counts = runs["jump"]["launches"]
        if (counts["jump_level"] != RUN_JUMP_K - 1
                or counts["pingpong_fm"] != runs["fm"]["launches"][
                    "pingpong_fm"]
                or not any(key[2] == RUN_JUMP_K
                           for key in spies["pingpong_fm"].shapes)):
            raise RuntimeError(f"kmer_jump run: {counts['jump_level']} K6 "
                               f"launches (want {RUN_JUMP_K - 1}), "
                               f"{counts['pingpong_fm']} K2 launches, "
                               f"K2 batches {spies['pingpong_fm'].shapes}")
        for k in ("auto", "oneshot", "fm", "wide"):
            if runs[k]["launches"]["jump_level"]:
                raise RuntimeError(f"{k} run launched the jump-table kernel")
    finally:
        for spy in spies.values():
            spy.restore()

    same = {}
    for f in ("specifics.txt", "variations.vcf"):
        want = open(os.path.join(dirs["host"], f), "rb").read()
        same[f] = len(want) > 0 and all(
            open(os.path.join(dirs[k], f), "rb").read() == want
            for k in ("auto", "oneshot", "fm", "wide", "jump"))
    quality = score_calls(os.path.join(dirs["auto"], "variations.vcf"),
                          sim["truth"])
    info = {"phase": "run", "genome_mbp": GENOME_MBP, "coverage": COVERAGE,
            "read_len": READ_LEN, "n_sv": N_SV, "reduced": [],
            "simulated_reads": sim["reads"], "simulate_s": sim["seconds"],
            "runs": {k: {f: v for f, v in r.items() if f != "tap"}
                     for k, r in runs.items()},
            "batches": {k: {f"{s[0]} cap {s[1]}" if len(s) == 2
                            else f"{s[0]} cap {s[1]} jump_k {s[2]}"
                            if k == "pingpong_fm"
                            else " ".join(map(str, s)): v
                            for s, v in spy.shapes.items()}
                        for k, spy in spies.items()},
            "identical_across_engines": same, **quality}
    emit(info)
    if not all(same.values()):
        raise RuntimeError(f"engines' outputs differ: {same}")
    if quality["recall"] < 0.9:
        raise RuntimeError(f"recall {quality['recall']:.3f} below 0.9")
    launches = dict(runs["auto"]["launches"])
    launches["anchor_batch"] = runs["oneshot"]["launches"]["anchor_batch"]
    launches["pingpong_fm"] = runs["fm"]["launches"]["pingpong_fm"]
    launches["anchor_wide"] = runs["wide"]["launches"]["anchor_wide"]
    launches["jump_level"] = runs["jump"]["launches"]["jump_level"]
    return {"launches": launches, "spies": spies,
            "index_path": os.path.join(dirs["auto"], "index.fmd.npz")}


# --------------------------------------------------------------- timing

def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def live_lanes(seqs, lens):
    """The lanes of a search batch that hold reads: the search stage fills
    a batch up to its lane count with one-symbol padding lanes, whose
    results nothing reads."""
    live = lens > 1
    return seqs[live], lens[live]


def time_pingpong(spy: Spy, index=None) -> dict:
    """K2 on the FM run's largest launch input; with `index`, on that table
    instead (the wide mode), and then also against narrow K2's output."""
    from svdss_tpu_torch.ops import pingpong
    _, (narrow, seqs, lens), kw = spy.best
    index = narrow if index is None else index
    Q, Lp1 = seqs.shape
    cap = kw["cap"]
    got = pingpong.batch_search(index, seqs, lens, **kw)
    # the work the reads need: the live lanes alone (results per lane do
    # not depend on the other lanes)
    lseqs, llens = live_lanes(seqs, lens)
    work = torch.zeros(1, dtype=torch.int64, device=seqs.device)
    live = pingpong.batch_search(index, lseqs, llens, work=work, **kw)
    torch.cuda.synchronize()
    steps = int(work.item())
    ms = cuda_ms(lambda: pingpong.batch_search(index, seqs, lens, **kw), 5)
    max_outer = -(-(8 * (Lp1 - 1) + 64) // pingpong.K_INNER)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", pingpong.batch_search_plain(index, seqs, lens, cap, max_outer,
                                         kw.get("overlap", -1))))
    err = max_abs_diff([getattr(got, f) for f in PP_FIELDS],
                       [getattr(holder["r"], f) for f in PP_FIELDS])
    vs_narrow = {}
    if index is not narrow:
        want = pingpong.batch_search(narrow, seqs, lens, **kw)
        vs_narrow["vs_narrow_max_abs_err"] = max_abs_diff(
            [getattr(got, f) for f in PP_FIELDS],
            [getattr(want, f) for f in PP_FIELDS])
        err = max(err, vs_narrow["vs_narrow_max_abs_err"])
    # bytes: each live lane's symbols and its sentinel once, its length
    # once, the rows the walk touches once (never more than the whole
    # table), the emissions written (8 B each) and the per-lane scalars
    table = index.fused.numel() * 4
    read_bytes = int((llens.long() + 1).sum())
    nbytes = (read_bytes + 4 * len(llens) + min(table, steps * 192)
              + 8 * int(live.n_sfs.sum()) + 6 * len(llens) + 4)
    bms, by = bound(nbytes, steps * OPS_PER_RANK_STEP)
    iters = int(got.iters)
    return {"shape": f"Q={Q} ({len(llens)} live) L+1={Lp1} cap={cap}",
            "wide": index.wide, "limb_bits": index.limb_bits,
            "rank_steps": steps, "iters": iters,
            "us_per_step": ms * 1e3 / iters,
            "read_bytes": read_bytes, "bound_bytes": nbytes,
            "table_MiB": table / 2 ** 20, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err, **vs_narrow}


def time_jump_level(index, k: int) -> dict:
    """K6 building the k-mer table of the run's index (k - 1 launches,
    timed together), held whole against its plain version. The bound:
    the fused rows the levels read (each once, counted from this index's
    intervals), C, and the table written; the operations of every
    parent. The time is the mean of 50 builds (~20 ms of work), a longer
    window than the other kernels' 5 launches, whose ~2 ms moved by a
    quarter between calls."""
    from svdss_tpu_torch.ops import fmd
    got = fmd.build_jump_table(index, k)
    ms = cuda_ms(lambda: fmd.build_jump_table(index, k), 50)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", fmd.build_jump_table_plain(index, k)))
    err = max_abs_diff([got], [holder["r"]])
    # the rows each level reads: at lo = x0 and hi = x0 + sz of its parents
    # (position 0 for an absent one)
    nblk = index.fused.shape[0]
    touched = torch.zeros(nblk, dtype=torch.bool, device=index.device)
    rows, parents = fmd.level_one(index), 0
    kinds = dict.fromkeys(JUMP_PARENT_INSNS, 0)
    for _ in range(1, k):
        live = rows[:, 2] > 0
        lo = torch.where(live, rows[:, 0], 0)
        hi = lo + torch.where(live, rows[:, 2], 0)
        touched[(lo >> 7).long()] = True
        touched[(hi >> 7).long()] = True
        one = live & ((lo >> 7) == (hi >> 7))
        kinds["absent"] += int((~live).sum())
        kinds["one_row"] += int(one.sum())
        kinds["two_rows"] += int((live & ~one).sum())
        parents += rows.shape[0]
        rows = fmd.jump_level_plain(index, rows)
    n_touched = int(touched.sum())
    nbytes = 192 * n_touched + 4 * 8 + 16 * 4 ** k
    bms, by = bound(nbytes, parents * OPS_PER_JUMP_PARENT)
    # the instructions the kernel issues for these parents (its note's
    # count), and the time they take at Hopper's integer issue rates
    insns = sum(n * JUMP_PARENT_INSNS[kd] for kd, n in kinds.items())
    popc = sum(n * JUMP_PARENT_POPC[kd] for kd, n in kinds.items())
    return {"shape": f"k={k} over {nblk} fused rows ({4 ** k} table rows)",
            "launches": k - 1, "parents": parents, "parent_kinds": kinds,
            "present": int((got[:, 2] > 0).sum()),
            "rows_touched": n_touched, "bound_bytes": nbytes,
            "bound_ops": parents * OPS_PER_JUMP_PARENT,
            "insns_per_parent": insns / parents,
            "issue_ms": ((insns - popc) / INT_LANES_PER_S
                         + popc / POPC_LANES_PER_S) * 1e3,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err, "table": got}


def time_pingpong_jump(spy: Spy, table, k: int) -> dict:
    """K2's jump mode on the FM run's largest launch input with the k-mer
    table of the run's index: its time, its plain version's, and its rank
    steps beside those of the same reads without jumps."""
    from svdss_tpu_torch.ops import pingpong
    _, (index, seqs, lens), kw = spy.best
    kw = dict(kw, jump_table=table, jump_k=k)
    Q, Lp1 = seqs.shape
    cap = kw["cap"]
    got = pingpong.batch_search(index, seqs, lens, **kw)
    lseqs, llens = live_lanes(seqs, lens)
    work = torch.zeros(2, dtype=torch.int64, device=seqs.device)
    live = pingpong.batch_search(index, lseqs, llens, work=work, **kw)
    plain_work = torch.zeros(1, dtype=torch.int64, device=seqs.device)
    nojump = pingpong.batch_search(index, lseqs, llens, work=plain_work,
                                   cap=cap)
    torch.cuda.synchronize()
    steps, jump_rows = work.tolist()
    ms = cuda_ms(lambda: pingpong.batch_search(index, seqs, lens, **kw), 5)
    nojump_ms = cuda_ms(lambda: pingpong.batch_search(index, seqs, lens,
                                                      cap=cap), 5)
    max_outer = -(-(8 * (Lp1 - 1) + 64) // pingpong.K_INNER)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", pingpong.batch_search_plain(index, seqs, lens, cap, max_outer,
                                         kw.get("overlap", -1),
                                         jump_table=table, jump_k=k)))
    err = max_abs_diff([getattr(got, f) for f in PP_FIELDS],
                       [getattr(holder["r"], f) for f in PP_FIELDS])
    done = ~(live.overflow | live.incomplete | nojump.overflow
             | nojump.incomplete)
    vs_nojump = max_abs_diff(
        [live.qs[done], live.length[done], live.n_sfs[done]],
        [nojump.qs[done], nojump.length[done], nojump.n_sfs[done]])
    # bytes as for K2 without jumps, plus the table rows read (16 B each,
    # never more than the table); operations as for K2 plus the keys
    fused = index.fused.numel() * 4
    read_bytes = int((llens.long() + 1).sum())
    nbytes = (read_bytes + 4 * len(llens) + min(fused, steps * 192)
              + min(table.numel() * 4, jump_rows * 16)
              + 8 * int(live.n_sfs.sum()) + 6 * len(llens) + 4)
    bms, by = bound(nbytes, steps * OPS_PER_RANK_STEP
                    + jump_rows * (k * OPS_PER_KEY_SYMBOL + 8))
    return {"shape": f"Q={Q} ({len(llens)} live) L+1={Lp1} cap={cap} k={k}",
            "rank_steps": steps,
            "rank_steps_without_jumps": int(plain_work.item()),
            "jump_rows": jump_rows, "iters": int(got.iters),
            "us_per_step": ms * 1e3 / int(got.iters),
            "iters_without_jumps": int(nojump.iters),
            "ms_without_jumps": nojump_ms, "bound_bytes": nbytes,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": max(err, vs_nojump),
            "vs_nojump_max_abs_err": vs_nojump}


def time_wavefront_at(args, lq: int, lt: int, p) -> dict:
    """K1 and its plain version on one input, with the µs a diagonal of
    the kernel and how many SMs its blocks (one a pair) keep busy."""
    from svdss_tpu_torch.ops import align_dp
    q, t, td, ti = args
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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return {"shape": f"B={B} lq={lq} lt={lt}", "ms": ms,
            "us_per_diagonal": ms * 1e3 / (D - 1),
            "sms_busy": f"{min(B, sms)} of {sms}",
            "global_scratch": align_dp.scratch_words(lq) > 0,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def time_wavefront(spy: Spy, rng) -> dict:
    """K1 on the call stage's largest launch input, and on the call stage's
    2048 x 2048 and 4096 x 4096 chunks (pipeline/call.py pcall: 32 and 8
    pairs) of dp_pairs."""
    from svdss_tpu_torch.pipeline.call import _CALL_PARAMS
    _, args, kw = spy.best
    q, t, td, ti, lq, lt = args[:6]
    p = args[6] if len(args) > 6 else kw.get("params")
    out = time_wavefront_at((q, t, td, ti), lq, lt, p)
    for bq in (2048, 4096):
        B = max(8, min(128, (256 << 20) // ((2 * bq) * (bq + 1))))
        chunk = pack_pairs(dp_pairs(rng, B, bq, bq), bq, bq)
        out[f"{bq}x{bq}"] = time_wavefront_at(chunk, bq, bq, _CALL_PARAMS)
        out["max_abs_err"] = max(out["max_abs_err"],
                                 out[f"{bq}x{bq}"]["max_abs_err"])
        del chunk
    return out


def anchor_bound(index, lens, work, n_sfs, scalars: int) -> tuple:
    """(bytes, ops) the anchor work of the reads `lens` needs: each read's
    symbols once, the lengths once, the table rows (16 B) and text rows
    (64 B) its rounds touched (each capped at its table), the emissions
    written (8 B each; the zeroed rest of each [cap] row is left out,
    nothing reads it) and `scalars` bytes of per-read results; the
    operations of its rounds and compared symbols."""
    rounds, rows, text_rows, syms = work
    nbytes = (int((lens.long() + 1).sum()) + 4 * lens.numel()
              + min(index.small.numel() * 4, rows * 16)
              + min(index.text_words.numel() * 4, text_rows * 64)
              + 8 * int(n_sfs.sum()) + scalars)
    return nbytes, (rounds * OPS_PER_ANCHOR_ROUND
                    + syms * OPS_PER_COMPARED_SYMBOL)


def time_anchor_batch(spy: Spy) -> dict:
    from svdss_tpu_torch.ops import anchor_device
    _, (index, params, seqs, lens), kw = spy.best
    Q, Lp1 = seqs.shape
    cap = kw["cap"]
    got = anchor_device.batch_search_anchor(index, params, seqs, lens, **kw)
    # the work the reads need: the live lanes alone (results per lane do
    # not depend on the other lanes)
    lseqs, llens = live_lanes(seqs, lens)
    work = torch.zeros(4, dtype=torch.int64, device=seqs.device)
    live = anchor_device.batch_search_anchor(index, params, lseqs, llens,
                                             work=work, **kw)
    torch.cuda.synchronize()
    work = work.tolist()
    ms = cuda_ms(lambda: anchor_device.batch_search_anchor(
        index, params, seqs, lens, **kw), 5)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", anchor_device.batch_search_anchor_plain(
            index, params, seqs, lens, cap, kw.get("max_rounds")
            or anchor_device.default_max_rounds(Lp1),
            kw.get("overlap", -1))))
    err = max_abs_diff([getattr(got, f) for f in ANCHOR_FIELDS],
                       [getattr(holder["r"], f) for f in ANCHOR_FIELDS])
    # per read: n_sfs, overflow, incomplete; and iters
    nbytes, ops = anchor_bound(index, llens, work, live.n_sfs,
                               6 * len(llens) + 4)
    bms, by = bound(nbytes, ops)
    return {"shape": f"Q={Q} ({len(llens)} live) L+1={Lp1} cap={cap} "
                     f"max_rounds={kw.get('max_rounds')}",
            "work": dict(zip(anchor_device.WORK_FIELDS, work)),
            "iters": int(got.iters), "ms_per_round": ms / int(got.iters),
            "bound_bytes": nbytes,
            "bound_ops": ops, "table_GiB": index.small.numel() * 4 / 2 ** 30,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def time_anchor_pool(spy: Spy) -> dict:
    from svdss_tpu_torch.ops import anchor_device, anchor_pool
    _, (index, params, syms, offs, lens), kw = spy.best
    M = lens.shape[0]
    cap, Lp1 = kw["cap"], kw["Lp1"]
    work = torch.zeros(4, dtype=torch.int64, device=syms.device)
    got = anchor_pool.pool_search(index, params, syms, offs, lens,
                                  work=work, **kw)
    torch.cuda.synchronize()
    work = work.tolist()
    ms = cuda_ms(lambda: anchor_pool.pool_search(index, params, syms, offs,
                                                 lens, **kw), 5)
    holder = {}
    plain_ms = once_ms(lambda: holder.setdefault(
        "r", anchor_pool.pool_search_plain(index, params, syms, offs, lens,
                                           Lp1, cap, kw.get("overlap", -1))))
    err = max_abs_diff(list(got), list(holder["r"]))
    # the slowest read's rounds: K3 on the same reads under the pool's
    # per-read budget (its iters), which must give K4's results
    col = torch.arange(Lp1, device=syms.device)[None, :]
    src = (offs[:, None] + col).clamp(max=syms.shape[0] - 1)
    seqs = torch.where(col < lens[:, None], syms[src], 0).to(torch.uint8)
    budget = anchor_pool.lane_budget(lens).to(torch.int32)
    k3 = anchor_device.batch_search_anchor(
        index, params, seqs, lens, cap=cap, budget=budget,
        max_rounds=int(budget.max()), overlap=kw.get("overlap", -1))
    err = max(err, max_abs_diff(list(got), [k3.qs, k3.length, k3.n_sfs,
                                            pool_flags(k3)]))
    iters = int(k3.iters)
    # per read: its offset into syms (8 B), n_sfs and flags
    nbytes, ops = anchor_bound(index, lens, work, got.n_sfs, 8 * M + 5 * M)
    bms, by = bound(nbytes, ops)
    return {"shape": f"M={M} lanes={kw.get('lanes')} L+1={Lp1} cap={cap}",
            "work": dict(zip(anchor_device.WORK_FIELDS, work)),
            "slowest_read_rounds": iters, "ms_per_round": ms / iters,
            "host_flags": int((got.flags != 0).sum()),
            "bound_bytes": nbytes, "bound_ops": ops, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def time_anchor_wide(spy: Spy) -> dict:
    """K5 on the wide run's largest launch: the same wave relaunched on
    fresh copies of the lane state it was given."""
    from svdss_tpu_torch.ops import anchor_wide_device as aw
    _, args, _ = spy.best
    (index, params, seqs, lens, state, oq, ol, rounds, r0, cap, max_rounds,
     overlap, park) = args[:13]
    Q, Lp1 = seqs.shape

    def fresh():
        return state.clone(), oq.clone(), ol.clone(), rounds.clone()

    def launch(st, s=seqs, ln=lens, work=None):
        aw.run_wave(index, params, s, ln, *st, r0, cap, max_rounds, overlap,
                    park, work)
    got = fresh()
    launch(got)
    # the work the reads need: the live lanes alone (lanes are
    # independent)
    live = lens > 1
    lst = (state[:, live].contiguous(), oq[live].contiguous(),
           ol[live].contiguous(), rounds.clone())
    work = torch.zeros(4, dtype=torch.int64, device=seqs.device)
    launch(lst, seqs[live].contiguous(), lens[live].contiguous(), work)
    torch.cuda.synchronize()
    work = work.tolist()
    copies = [fresh() for _ in range(6)]
    launch(copies[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for st in copies[1:]:
        launch(st)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / 5
    plain = fresh()
    chunks = aw.read_chunks(seqs, lens)
    plain_ms = once_ms(lambda: aw.run_wave_plain(
        index, params, chunks, lens, *plain, r0, cap, max_rounds, overlap,
        park))
    mine, want = aw.result_of(*got), aw.result_of(*plain)
    err = max_abs_diff([getattr(mine, f) for f in ANCHOR_FIELDS],
                       [getattr(want, f) for f in ANCHOR_FIELDS])
    # bytes: each live read's symbols once, its length and its lane state
    # (read and written back), one 32-bit table word per table row read
    # (capped at the tables), 2 bits per compared text symbol and a
    # badrow word per compare (capped at the text), 8 B per emission
    # written, the round count
    rounds_n, rows, text_rows, syms = work
    llens = lens[live]
    n_live = int(live.sum())
    tables = sum(t.numel() * 4 for t in (index.ct, index.aux,
                                          index.pospairs, index.bms,
                                          index.lperm))
    text = (index.text2.numel() + index.badrow.numel()) * 4
    emitted = int(lst[0][aw.S["nsfs"]].sum())
    nbytes = (int((llens.long() + 1).sum()) + 4 * n_live
              + 2 * 4 * len(aw.STATE) * n_live + min(tables, 4 * rows)
              + min(text, -(-syms // 4) + 4 * text_rows) + 8 * emitted + 4)
    bms, by = bound(nbytes, rounds_n * OPS_PER_ANCHOR_ROUND
                    + syms * OPS_PER_COMPARED_SYMBOL)
    slowest = int(mine.iters) - r0
    return {"shape": f"Q={Q} ({n_live} live) L+1={Lp1} cap={cap} "
                     f"park={park} r0={r0}",
            "work": dict(zip(aw.WORK_FIELDS, work)),
            "iters": int(mine.iters), "slowest_lane_rounds": slowest,
            "us_per_round": ms * 1e3 / slowest, "bound_bytes": nbytes,
            "tables_GiB": (tables + text) / 2 ** 30, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def phase_timing(run: dict, seed: int) -> dict:
    from svdss_tpu_torch.index.fmd import FMDIndex
    from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
    spies = run["spies"]
    wide = DeviceFMDIndex.from_host(FMDIndex.load(run["index_path"]),
                                    "cuda", force_wide=True)
    narrow = spies["pingpong_fm"].best[1][0]
    jump = time_jump_level(narrow, RUN_JUMP_K)
    table = jump.pop("table")
    out = {"pingpong_fm": time_pingpong(spies["pingpong_fm"]),
           "pingpong_fm_wide": time_pingpong(spies["pingpong_fm"], wide),
           "jump_level": jump,
           "pingpong_fm_jump": time_pingpong_jump(spies["pingpong_fm"],
                                                  table, RUN_JUMP_K),
           "anchor_batch": time_anchor_batch(spies["anchor_batch"]),
           "anchor_pool": time_anchor_pool(spies["anchor_pool"]),
           "anchor_wide": time_anchor_wide(spies["anchor_wide"]),
           "wavefront_dp": time_wavefront(spies["wavefront_dp"],
                                          np.random.default_rng(seed))}
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
    ("anchor_batch", "svdss_tpu_torch/csrc/anchor.cu",
     "svdss_tpu/ops/anchor_jax.py:646"),
    ("anchor_pool", "svdss_tpu_torch/csrc/anchor.cu",
     "svdss_tpu/ops/anchor_pool.py:114"),
    ("anchor_wide", "svdss_tpu_torch/csrc/anchor_wide.cu",
     "svdss_tpu/ops/anchor_wide_jax.py:1144"),
    ("wavefront_dp", "svdss_tpu_torch/csrc/wavefront.cu",
     "svdss_tpu/ops/align_pallas.py:181"),
    ("jump_level", "svdss_tpu_torch/csrc/jump.cu",
     "svdss_tpu/ops/fmd_jax.py:500"),
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
        timing = phase_timing(run, args.seed)
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
