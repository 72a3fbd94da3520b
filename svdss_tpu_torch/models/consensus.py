"""POA consensus alignment record (reference ``Consensus``, caller.hpp:39-71).

Serialized as a SAM-ish line by the optional ``--poa`` dump
(caller.cpp:65-75)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Consensus:
    seq: str
    cigar: str
    chrom: str
    s: int
    e: int

    def sam_line(self) -> str:
        # caller.hpp:56-70
        return (f"{self.chrom}:{self.s + 1}-{self.e + 1}\t0\t{self.chrom}\t"
                f"{self.s + 1}\t60\t{self.cigar}\t*\t0\t0\t{self.seq}\t*")

    __str__ = sam_line
