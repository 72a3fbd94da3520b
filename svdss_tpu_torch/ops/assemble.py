"""Merge overlapping SFSs on the same read.

Exact reimplementation of ``Assembler::assemble`` (assembler.cpp:34-56):
sort by query start, then greedily chain SFSs while consecutive ones overlap
(prev.qs + prev.l > next.qs); each chain is emitted as a single SFS from the
first's start to the last's end, keeping the first's haplotype tag.
"""

from __future__ import annotations

from typing import List

from ..models import SFS


def assemble(sfs_list: List[SFS]) -> List[SFS]:
    if not sfs_list:
        return []
    sfs = sorted(sfs_list, key=lambda s: s.qs)
    out: List[SFS] = []
    i = 0
    n = len(sfs)
    while i < n:
        j = i + 1
        while j < n and sfs[j - 1].qs + sfs[j - 1].l > sfs[j].qs:
            j += 1
        length = sfs[j - 1].qs + sfs[j - 1].l - sfs[i].qs
        out.append(SFS(sfs[i].qname, sfs[i].qs, length, sfs[i].htag))
        i = j
    return out
