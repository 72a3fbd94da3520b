"""Cluster of placed SFSs and their supporting subread sequences.

Mirrors the reference ``SubRead``/``Cluster`` structs (clusterer.hpp:24-139):
a cluster is a genomic interval [s, e] with the SFSs that voted for it, the
per-haplotype coverage split, the read-support vector consumed by the
genotyper, and the per-supporting-read subsequences spanning the interval.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .sfs import SFS


@dataclasses.dataclass
class SubRead:
    name: str
    seq: str
    htag: int  # 0: untagged, 1: hap1, 2: hap2

    def size(self) -> int:
        return len(self.seq)


@dataclasses.dataclass
class Cluster:
    chrom: str = ""
    s: int = 0
    e: int = 0
    cov: int = 0
    cov0: int = 0
    cov1: int = 0
    cov2: int = 0
    SFSs: List[SFS] = dataclasses.field(default_factory=list)
    reads: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    subreads: List[SubRead] = dataclasses.field(default_factory=list)

    @classmethod
    def from_sfs(cls, sfs_list: List[SFS]) -> "Cluster":
        return cls(chrom=sfs_list[0].chrom, SFSs=list(sfs_list))

    def clear(self) -> None:
        self.SFSs = []
        self.subreads = []

    def set_coordinates(self, s: int, e: int) -> None:
        self.s, self.e = s, e

    def set_cov(self, coverages: List[int]) -> None:
        # clusterer.hpp:113-118
        self.cov0, self.cov1, self.cov2 = coverages
        self.cov = self.cov0 + self.cov1 + self.cov2

    def set_reads(self, reads: List[Tuple[int, int]]) -> None:
        self.reads = list(reads)

    def add_subread(self, name_or_sr, seq: str | None = None,
                    htag: int | None = None) -> None:
        if isinstance(name_or_sr, SubRead):
            self.subreads.append(name_or_sr)
        else:
            self.subreads.append(SubRead(name_or_sr, seq, htag))

    def get_len(self) -> int:
        # mean subread length, integer division (clusterer.hpp:121-129)
        total = sum(sr.size() for sr in self.subreads)
        return total // len(self.subreads)

    def get_names(self) -> List[str]:
        return [sr.name for sr in self.subreads]

    def get_seqs(self) -> List[str]:
        return [sr.seq for sr in self.subreads]

    def size(self) -> int:
        return len(self.subreads)

    def shallow_copy_meta(self) -> "Cluster":
        """Copy with coordinates/coverage but no SFSs/subreads
        (= reference copy-ctor + clear(), caller.cpp:102-107)."""
        return Cluster(chrom=self.chrom, s=self.s, e=self.e, cov=self.cov,
                       cov0=self.cov0, cov1=self.cov1, cov2=self.cov2)
