"""``specifics.txt`` SFS-file format.

The 4-column TSV emitted by ``search`` and consumed by ``call``:
``readname\\tquery_start\\tlength\\thaplotag``, where repeated read names are
run-length encoded as ``*`` (reference output_batch, ping_pong.cpp:224-229;
parser parse_sfsfile, sfs.cpp:5-30). The reference terminates every line with
a trailing ``\\t`` before the newline (ping_pong.cpp:227-228); we reproduce
that so files are byte-interchangeable.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, TextIO, Tuple

from ..models import SFS


def write_sfs_file(out: TextIO,
                   per_read: Iterable[Tuple[str, List[SFS]]]) -> int:
    """Write (readname, [SFS]) groups; returns number of SFS written."""
    n = 0
    for qname, sfs_list in per_read:
        first = True
        for sfs in sfs_list:
            name = qname if first else "*"
            out.write(f"{name}\t{sfs.qs}\t{sfs.l}\t{sfs.htag}\t\n")
            first = False
            n += 1
    return n


def parse_sfs_file(path: str) -> Dict[str, List[SFS]]:
    """read name -> [SFS], mirroring parse_sfsfile (sfs.cpp:5-30)."""
    out: Dict[str, List[SFS]] = {}
    read_name = None
    with open(path) as fh:
        for line in fh:
            fields = line.split()
            if not fields:
                continue
            if fields[0] != "*":
                read_name = fields[0]
                out[read_name] = []
            out[read_name].append(
                SFS(read_name, int(fields[1]), int(fields[2]),
                    int(fields[3])))
    return out
