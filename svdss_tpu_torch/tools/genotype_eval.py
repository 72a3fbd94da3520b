"""Genotyper accuracy on a simulated truth set: the JAX repo's
tools/genotype_eval.py.

    python -m svdss_tpu_torch.tools.genotype_eval [--genome-mbp 8]
        [--coverage 30] [--read-len 9000] [--n-hom 14] [--n-het 14]
        [--seed 97] [--no-device] [--device cuda|cpu]
        [--workdir build/genotype_eval] [--out FILE]

The reference tool delegates genotyping to kanpig; the JAX package (and
the port, which copies it verbatim: pipeline/genotype.py) genotypes with
its own Bayesian model. This scores it against haplotype truth: a diploid
sample whose haplotype 1 carries SV sets A and B and haplotype 2 only B
(B true 1/1, A true 1|0), the JAX tool's construction draw for draw (seed
97; a het event within 1,200 bp of a hom one is dropped). ``python -m
svdss_tpu_torch.cli run --threads 2`` calls and genotypes it on the card
(the default engine choice, then the DP kernel K1; --no-device: the exact
host engines, the JAX record's path; --device cpu: the kernels' plain
versions). Each planted SV is matched to the nearest call of its type
within 200 bp and its zygosity class (het or hom) compared.

Everything is written under --workdir (ref.fa, reads.bam, the run's
directory) and the report to --out (default WORKDIR/genotype.json), never
to docs/, where the JAX record lives.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import common as C
from ..utils.device import resolve_device

# the command that runs the pipeline (a wrapper may stand in for it)
CLI = [sys.executable, "-m", "svdss_tpu_torch.cli"]
DEVIATION = ("internal Bayesian genotyper stands in for the reference's "
             "external kanpig delegation (run_svdss:186-204); scored "
             "against planted haplotype zygosity")


def make_truth(genome_mbp: int, n_hom: int, n_het: int, seed: int):
    """genotype_eval.py's sample before its reads: (rng, chroms, events,
    haplotype 1, haplotype 2, truth {(type, pos): "hom" | "het"}); rng is
    left where the JAX tool draws the reads from it."""
    from ..utils.simulate import Haplotype, make_haplotype, random_genome
    rng = np.random.default_rng(seed)
    n = genome_mbp * 1_000_000
    chroms = random_genome(rng, {"chrG": n})
    ref = chroms["chrG"]
    hom = make_haplotype(rng, "chrG", ref, n_ins=n_hom // 2,
                         n_del=n_hom - n_hom // 2)
    both = make_haplotype(rng, "chrG", ref, n_ins=n_het // 2,
                          n_del=n_het - n_het // 2)
    events = [(sv, "hom") for sv in hom.svs]
    for sv in both.svs:
        # skip het events that collide with a hom event's span
        if any(abs(sv.pos - h.pos) < 1200 for h in hom.svs):
            continue
        events.append((sv, "het"))
    events.sort(key=lambda e: e[0].pos)

    def build_hap(kinds) -> Haplotype:
        segments, svs, cur = [], [], 0
        for sv, kind in events:
            if kind not in kinds:
                continue
            p = sv.pos + 1
            segments.append(("M", cur, p))
            svs.append(sv)
            if sv.type == "DEL":
                cur = p + sv.length
            else:
                segments.append(("I", p, sv.seq))
                cur = p
        segments.append(("M", cur, n))
        return Haplotype("chrG", ref, segments, svs)

    h1, h2 = build_hap(("hom", "het")), build_hap(("hom",))
    truth = {(sv.type, sv.pos): kind for sv, kind in events}
    return rng, chroms, events, h1, h2, truth


def read_calls(vcf: str) -> List[Tuple[str, int, str]]:
    """(type, POS, GT) of each VCF record."""
    calls = []
    with open(vcf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fld = line.split("\t")
            svtype = "DEL" if "SVTYPE=DEL" in fld[7] else "INS"
            gt = fld[9].split(":")[0] if len(fld) > 9 else "./."
            calls.append((svtype, int(fld[1]), gt))
    return calls


def score(truth: Dict[Tuple[str, int], str], calls) -> Tuple[dict, list]:
    """genotype_eval.py's scoring: each planted SV against the nearest call
    of its type within 200 bp, its zygosity class compared. Returns (the
    JAX tool's numbers, one row per planted SV)."""
    n_match = n_gt_right = n_het_right = n_hom_right = 0
    n_het = n_hom = 0
    rows = []
    for (svtype, pos), kind in sorted(truth.items(), key=lambda x: x[0][1]):
        if kind == "hom":
            n_hom += 1
        else:
            n_het += 1
        best = None
        for ct, cp, gt in calls:
            if ct == svtype and abs(cp - (pos + 1)) <= 200:
                if best is None or abs(cp - pos) < abs(best[1] - pos):
                    best = (ct, cp, gt)
        if best is None:
            rows.append((svtype, pos, kind, "MISSED"))
            continue
        n_match += 1
        gt = best[2].replace("|", "/")
        ok = (kind == "hom" and gt == "1/1") or (
            kind == "het" and gt in ("0/1", "1/0"))
        n_gt_right += ok
        if kind == "hom":
            n_hom_right += ok
        else:
            n_het_right += ok
        rows.append((svtype, pos, kind, gt))
    return {"n_truth": len(truth), "n_called": n_match,
            "n_het_truth": n_het, "n_hom_truth": n_hom,
            "gt_concordance": round(n_gt_right / max(1, n_match), 4),
            "het_right": n_het_right, "hom_right": n_hom_right}, rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mbp", type=int, default=8)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=9000)
    ap.add_argument("--n-hom", type=int, default=14,
                    help="SVs on both haplotypes (true 1/1)")
    ap.add_argument("--n-het", type=int, default=14,
                    help="SVs on haplotype 1 only (true 1|0)")
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--no-device", action="store_true",
                    help="the exact host engines (the JAX record's path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default="build/genotype_eval")
    ap.add_argument("--out", default=None,
                    help="the report (default WORKDIR/genotype.json)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from ..io.fasta import write_fasta
    from ..utils.simulate import simulate_reads, write_bam

    rng, chroms, events, h1, h2, truth = make_truth(
        args.genome_mbp, args.n_hom, args.n_het, args.seed)
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    ref_fa, bam = os.path.join(wd, "ref.fa"), os.path.join(wd, "reads.bam")
    write_fasta(ref_fa, chroms)
    recs = simulate_reads(rng, [h1, h2], coverage=args.coverage,
                          read_len=args.read_len)
    write_bam(bam, chroms, recs)
    kinds = [k for _, k in events]
    print(f"[gt] {len(recs)} reads over {args.genome_mbp} Mbp "
          f"({kinds.count('hom')} hom + {kinds.count('het')} het SVs)",
          flush=True)

    outdir = os.path.join(wd, "out")
    # `run` reuses the stages it finds: start from an empty directory
    shutil.rmtree(outdir, ignore_errors=True)
    cmd = [*CLI, "run", "--reference", ref_fa, "--bam", bam, "--workdir",
           outdir, "--threads", "2"]
    cmd += ["--no-device"] if args.no_device else (
        ["--device", "cpu"] if dev.type == "cpu" else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = C.PKG_PARENT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.time()
    r = subprocess.run(cmd, cwd=C.PKG_PARENT, env=env, capture_output=True,
                       text=True)
    if r.returncode != 0:
        print(r.stderr[-3000:])
        return 1
    pipeline_s = time.time() - t0
    print(f"[gt] pipeline {pipeline_s:.1f}s", flush=True)

    out, rows = score(truth, read_calls(os.path.join(outdir,
                                                     "variations.vcf")))
    out["deviation_note"] = DEVIATION
    out["path"] = "host" if args.no_device else "device"
    out.update({"pipeline_s": pipeline_s}
               if args.no_device or dev.type == "cuda"
               else C.device_number(dev, "pipeline_s", pipeline_s))
    out["device"] = C.card_info(dev)
    for r_ in rows:
        print(f"[gt] {r_[0]} @{r_[1]} truth={r_[2]} called={r_[3]}",
              flush=True)
    print(json.dumps(out), flush=True)
    with open(args.out or os.path.join(wd, "genotype.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
