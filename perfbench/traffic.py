"""The benchmark's general generator: a reference from a configuration's
file, a sample's reads from a traffic mix's file and the run's seed.

The reference sequence is fixed by the configuration (uniform ACGT from its
own seed, at the chromosome's published length). The seed of a run varies
the sample: the order of the reads, where each read lies, its SV's place,
its novel bases and its substitutions. What each read is (its length, its
SV's kind and size) follows a plan that is the same for every batch and
every seed (`batch_plan`: quantiles of the mix's distributions), so every
seed, and every batch, asks for the same work.

The read pattern is that of ``svdss_tpu_torch/tools/bench.py``
``make_reads`` (uniform starts on the forward strand, a share of reads
with one novel insertion, 0.2% substitutions: what smoothing leaves),
extended with HiFi lengths, deletions and a size range per SV kind.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

NT6_ASCII = np.frombuffer(b"NACGT", dtype=np.uint8)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one purpose (`stream`) of one run's seed; any whole
    number is a seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def reference_nt6(config: dict) -> np.ndarray:
    """The configuration's reference sequence, nt6 codes (A=1 .. T=4)."""
    ref = config["reference"]
    return np.random.default_rng(int(ref["seed"])).integers(
        1, 5, int(ref["length_bp"]), dtype=np.uint8)


def reference_chroms(config: dict, nt6: np.ndarray) -> dict:
    """{name: ASCII sequence}, as a FASTA loader gives it."""
    return {config["reference"]["name"]: NT6_ASCII[nt6].tobytes().decode()}


def _lengths(spec: dict, n: int) -> np.ndarray:
    """n read lengths at the quantiles (i + 0.5) / n of the mix's
    distribution, clipped to its range."""
    if spec["distribution"] == "fixed":
        return np.full(n, int(spec["median"]), dtype=np.int64)
    if spec["distribution"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['distribution']}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(out, spec["min"], spec["max"]).astype(np.int64)


def _sizes(sv: dict, n: int) -> np.ndarray:
    """n SV sizes at the quantiles of a log-uniform spread over the kind's
    range."""
    lo, hi = math.log(sv["min"]), math.log(sv["max"])
    q = (np.arange(n) + 0.5) / max(n, 1)
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


@dataclasses.dataclass
class ReadSet:
    """One sample's reads, replayed in order through a run."""
    reads: List[np.ndarray]     # nt6 uint8
    lengths: np.ndarray         # int64
    sv_kind: np.ndarray         # int8: -1 none, else index into the mix's svs
    sv_size: np.ndarray         # int64, 0 without an SV

    def names(self) -> List[str]:
        return [f"read{i}" for i in range(len(self.reads))]


def batch_plan(traffic: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lengths, SV kinds, SV sizes) of one batch, the same for every seed:
    lengths and each kind's sizes at their quantiles, each SV given to a
    read by a fixed draw. A run's batches are this plan in orders drawn
    from its seed, so every batch, and every seed, asks for the same
    work."""
    n = int(traffic["batch_reads"])
    lengths = _lengths(traffic["read_length"], n)
    kind = np.full(n, -1, dtype=np.int8)
    size = np.zeros(n, dtype=np.int64)
    carriers = np.random.default_rng(0).permutation(n)
    at = 0
    for k, sv in enumerate(traffic.get("svs", [])):
        m = int(round(sv["share"] * n))
        who = carriers[at:at + m]
        at += m
        kind[who] = k
        size[who] = _sizes(sv, m)
    return lengths, kind, size


def make_reads(genome: np.ndarray, traffic: dict, seed: int) -> ReadSet:
    """The mix's read set for `seed` over the reference `genome` (nt6):
    `set_batches` batches, each the batch plan in an order drawn from the
    seed, each read placed, cut and mutated by the seed."""
    plan = batch_plan(traffic)
    rng = rng_for(seed, 0)
    order = np.concatenate([
        rng.permutation(len(plan[0]))
        for _ in range(int(traffic["set_batches"]))])
    lengths, kind, size = (a[order] for a in plan)
    n = len(order)
    margin = int(traffic.get("sv_margin", 0))
    rate = float(traffic.get("snv_rate", 0.0))
    svs = traffic.get("svs", [])
    G = len(genome)
    reads = []
    for i in range(n):
        L = int(lengths[i])
        ins = dele = 0
        if kind[i] >= 0:
            if svs[kind[i]]["type"] == "insertion":
                ins = int(size[i])
            else:
                dele = int(size[i])
        span = L - ins + dele
        start = int(rng.integers(0, G - span + 1))
        src = genome[start:start + span]
        if kind[i] >= 0:
            cut = int(rng.integers(margin, L - ins - margin + 1))
            novel = rng.integers(1, 5, ins, dtype=np.uint8)
            read = np.concatenate([src[:cut], novel, src[cut + dele:]])
        else:
            read = src.copy()
        m = int(round(rate * L))
        if m:
            pos = rng.integers(0, L, m)
            # a substitution always changes the base
            read[pos] = (read[pos] - 1 + rng.integers(1, 4, m)) % 4 + 1
        reads.append(np.ascontiguousarray(read, dtype=np.uint8))
    return ReadSet(reads, lengths, kind, size)
