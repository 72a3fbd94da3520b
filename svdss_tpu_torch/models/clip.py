"""Soft-clip evidence record (reference ``Clip``, clipper.hpp:22-43)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Clip:
    name: str
    chrom: str
    p: int           # breakpoint position on the reference
    l: int           # clip length
    starting: bool   # True = left clip (read starts clipped)
    w: int = 0       # weight (set when clips are combined)

    def sort_key(self):
        return self.p
