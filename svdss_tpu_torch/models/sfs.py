"""Sample-specific string (SFS) record.

Mirrors the reference ``SFS`` struct (sfs.hpp:31-79): before placement an SFS
is (read name, query start, length, haplotype tag); after placement on the
genome it additionally carries (chrom, ref start/end, query start/end).

The reference overloads one struct and one ``operator<`` for both phases
(noted FIXME at sfs.hpp:66); here the ordering is explicit via sort keys.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SFS:
    qname: str
    qs: int          # query start (0-based)
    l: int           # length on the query
    htag: int = 0    # 0: untagged, 1: hap1, 2: hap2
    # set after placement (clusterer):
    chrom: str = ""
    rs: int = -1     # reference start
    re: int = -1     # reference end (inclusive, like the reference code)
    qe: int = -1     # query end

    @classmethod
    def placed(cls, chrom: str, qname: str, rs: int, re: int, qs: int, qe: int,
               htag: int) -> "SFS":
        # mirrors SFS(chrom, qname, rs, re, qs, qe, htag) (sfs.hpp:52-63):
        # l = qe - qs + 1
        return cls(qname=qname, qs=qs, l=qe - qs + 1, htag=htag,
                   chrom=chrom, rs=rs, re=re, qe=qe)

    def query_key(self):
        return self.qs

    def ref_key(self):
        return (self.chrom, self.rs)
