"""Structural-variant record and VCF serialization.

Field-for-field port of the reference ``SV`` (sv.hpp:12-62) with the same
VCF line layout (sv.cpp:53-80): ID = ``TYPE_chrom:s-e_abs(l)``, SVLEN is
negative for deletions, INFO carries WEIGHT/COV*/AS/NV/CIGAR/RVEC/READS, and
the single sample column is ``GT:GQ``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class SV:
    type: str          # "INS" | "DEL"
    chrom: str
    s: int             # POS (the reference emits its 0-based coordinate as-is)
    refall: str
    altall: str
    w: int             # supporting-alignment weight
    cov: int
    ngaps: int         # NV: number of variations on the same consensus
    score: int         # AS: consensus-vs-reference alignment score
    imprecise: bool = False
    l: int = 0
    cigar: str = "."
    e: int = 0
    cov0: int = 0
    cov1: int = 0
    cov2: int = 0
    gt: str = "./."
    gtq: int = 0
    reads: str = ""
    rvec: str = ""

    def __post_init__(self) -> None:
        self.e = self.s + len(self.refall) - 1  # sv.cpp:16
        self.idx = (f"{self.type}_{self.chrom}:{self.s}-{self.e}"
                    f"_{abs(self.l)}")          # sv.cpp:23-24

    def add_reads(self, names: List[str]) -> None:
        self.reads = ",".join(names)

    def set_cov(self, cov: int, cov0: int, cov1: int, cov2: int) -> None:
        self.cov, self.cov0, self.cov1, self.cov2 = cov, cov0, cov1, cov2

    def set_rvec(self, reads: List[Tuple[int, int]]) -> None:
        # "hasSFS:haplotype-..." vector consumed by the genotyper (sv.cpp:42-46)
        self.rvec = "-".join(f"{a}:{b}" for a, b in reads)

    def set_gt(self, gt: str, gtq: int) -> None:
        self.gt, self.gtq = gt, gtq

    def sort_key(self):
        return (self.chrom, self.s)  # sv.hpp:45-53

    def vcf_line(self) -> str:
        svlen = -self.l if self.type == "DEL" else self.l  # sv.cpp:63
        info = (
            f"VARTYPE=SV;SVTYPE={self.type};SVLEN={svlen};END={self.e};"
            f"WEIGHT={self.w};COV={self.cov};COV0={self.cov0};"
            f"COV1={self.cov1};COV2={self.cov2};AS={self.score};"
            f"NV={self.ngaps};CIGAR={self.cigar};RVEC={self.rvec};"
            f"READS={self.reads}" + (";IMPRECISE" if self.imprecise else "")
        )
        return (f"{self.chrom}\t{self.s}\t{self.idx}\t{self.refall}\t"
                f"{self.altall}\t.\tPASS\t{info}\tGT:GQ\t{self.gt}:{self.gtq}")

    __str__ = vcf_line
