"""Internal Bayesian SV genotyper.

The reference repo contains a genotyper class that is *never compiled*
(genotyper.cpp, absent from CMakeLists.txt:20); production genotyping is
delegated to the external tool kanpig (run_svdss:186-204). This module makes
the in-framework genotyper a working, first-class option so the pipeline is
self-contained: posterior over {0/0, 0/1, 1/0, 1/1} from the per-locus read
vector (has-SFS, haplotag) that the cluster stage already produces for the
VCF RVEC field (clusterer.cpp:540-545).

Model (likelihoods/priors from genotyper.cpp:10-73):
    P(read has SFS | allele carries SV)      = 0.8
    P(read has SFS | allele is reference)    = 0.05
    P(read lacks SFS | allele is reference)  = 0.95
    P(read lacks SFS | allele carries SV)    = 0.2
    P(read drawn from its tagged haplotype)  = 0.95 (0.5 if untagged)
    genotype priors: 0/0 = 0.5, 0/1 = 1/0 = 0.22, 1/1 = 0.06

The reference implementation sums raw per-read likelihoods where it means
to sum logs (genotyper.cpp:96-105); since the code was never enabled, we
implement the corrected log-space model rather than reproduce the bug.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

GENOTYPES = ((0, 0), (0, 1), (1, 0), (1, 1))
_GT_PRIOR = {(0, 0): 0.5, (0, 1): 0.22, (1, 0): 0.22, (1, 1): 0.06}


def _p_sfs_given_allele(has_sfs: int, allele: int) -> float:
    if has_sfs == 1 and allele == 1:
        return 0.8
    if has_sfs == 0 and allele == 0:
        return 0.95
    if has_sfs == 0 and allele == 1:
        return 0.2
    return 0.05


def _p_hap(hap: int, tag: int) -> float:
    if tag == 3:
        return 0.5
    return 0.95 if hap == tag else 0.05


def read_likelihood(read: Tuple[int, int], gt: Tuple[int, int]) -> float:
    has_sfs, tag = read
    return (_p_sfs_given_allele(has_sfs, gt[0]) * _p_hap(1, tag)
            + _p_sfs_given_allele(has_sfs, gt[1]) * _p_hap(2, tag))


def genotype_posteriors(reads: Sequence[Tuple[int, int]]) -> List[float]:
    """Posterior P(gt | reads) over GENOTYPES order."""
    logp = []
    for gt in GENOTYPES:
        lp = math.log(_GT_PRIOR[gt])
        for r in reads:
            lp += math.log(max(read_likelihood(r, gt), 1e-300))
        logp.append(lp)
    m = max(logp)
    w = [math.exp(x - m) for x in logp]
    tot = sum(w)
    return [x / tot for x in w]


def genotype_call(reads: Sequence[Tuple[int, int]]) -> Tuple[str, int]:
    """(GT string, phred-like quality) for a read-support vector."""
    if not reads:
        return "./.", 0
    post = genotype_posteriors(reads)
    best = max(range(4), key=lambda i: post[i])
    gt = GENOTYPES[best]
    err = max(1.0 - post[best], 1e-10)
    q = min(100, int(round(-10.0 * math.log10(err))))
    return f"{gt[0]}/{gt[1]}", q


def parse_rvec(rvec: str) -> List[Tuple[int, int]]:
    """Parse the VCF RVEC field back into (has_sfs, tag) pairs."""
    out = []
    for part in rvec.split("-"):
        if not part:
            continue
        a, b = part.split(":")
        out.append((int(a), int(b)))
    return out
