"""FASTA loading.

Equivalent of the reference genome loader (chromosomes.cpp:9-27): loads every
sequence of a FASTA file (plain or gzip) into memory, uppercased, keyed by
name. Returns an insertion-ordered dict — the reference keeps a parallel
``vector<string> chromosomes`` for ordering, which dict order subsumes.
"""

from __future__ import annotations

import gzip
from typing import Dict


def _open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def load_chromosomes(path: str) -> Dict[str, str]:
    """name -> uppercase sequence, in file order."""
    chroms: Dict[str, str] = {}
    name = None
    parts = []
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    chroms[name] = "".join(parts).upper()
                name = line[1:].split()[0]
                parts = []
            elif line:
                parts.append(line)
        if name is not None:
            chroms[name] = "".join(parts).upper()
    return chroms


def write_fasta(path: str, chroms: Dict[str, str], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in chroms.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
