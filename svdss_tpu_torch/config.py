"""Pipeline configuration.

A plain dataclass replacing the reference's cxxopts-backed singleton
(``Configuration``, config.hpp:56-114). Defaults mirror config.hpp:68-103,
including the quirk that ``min_sv_length`` is floored at 25 (config.cpp:87).

Constants the reference hardcodes deep in the code are surfaced here as
fields (SURVEY.md "Config / flag system"): cluster separation factor
(clusterer.cpp:413), chain-merge thresholds (caller.cpp:451-459), clipper
thresholds (clipper.cpp:144-209), and the smoother accuracy sample size
(smoother.cpp:266).

The reference's dead flags ``--overlap`` / ``--trf`` (documented or read but
never registered with the parser, config.cpp:74, config.hpp:27) are
deliberately *not* reproduced; ``overlap`` is kept as a real field with the
only value the reference can ever use (-1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # general
    threads: int = 4
    batch_size: int = 10000
    verbose: bool = False

    # smoother
    accp: float = 0.98
    accuracy_sample: int = 10000      # smoother.cpp:266
    min_indel_length: int = 20

    # search
    assemble: bool = True
    putative: bool = True
    overlap: int = -1                 # consecutive ping-pong searches overlap by 1bp
    max_output: int = 100000
    max_sfs_per_read: int = 512       # device emission buffer bound; overflow
                                      # lanes re-run on the exact host path

    # call
    flank: int = 100
    ksize: int = 7
    min_sv_length: int = 25           # floored at 25 like config.cpp:87
    min_mapq: int = 20
    min_cluster_weight: int = 2
    min_ratio: float = 0.97
    useht: bool = True
    clipped: bool = False

    # hardcoded-in-reference thresholds, surfaced
    cluster_separation_factor: float = 1.1   # clusterer.cpp:413
    chain_merge_distance: int = 100          # caller.cpp:451
    chain_weight_ratio: float = 0.9          # caller.cpp:451
    chain_similarity: float = 70.0           # caller.cpp:459
    clip_min_weight: int = 2                 # clipper.cpp:144
    clip_cluster_radius: int = 1000          # clipper.cpp:146
    clip_var_exclusion: int = 1000           # caller.cpp:41
    clip_del_min_gap: int = 2000             # clipper.cpp:204
    clip_del_max_gap: int = 50000            # clipper.cpp:204
    clip_del_min_weight: int = 5             # clipper.cpp:209

    # device execution
    lanes: int = 4096                 # lockstep ping-pong batch width
    use_device: bool = True           # False -> pure-host reference path
    engine: str = "auto"              # device search engine: "fm" (rank
                                      # walk), "anchor" (k-mer anchor +
                                      # text verify), "auto" = anchor when
                                      # its tables exist / are buildable
    anchor_cmax: int = 16             # anchor engine: max occurrences
                                      # verified per k-mer before the lane
                                      # falls back to the exact FM path
    pool: Optional[bool] = None       # anchor engine: persistent-lane pool
                                      # (refill lanes from the stream as
                                      # they finish) instead of one-shot
                                      # batches that wait for the slowest
                                      # lane. None = auto: pool only when
                                      # the measured host<->device link is
                                      # fast enough that its per-superstep
                                      # transfers are not the bottleneck
    kmer_jump: int = 0                # k-mer jump-start table size (0 = off,
                                      # the measured default: the per-step
                                      # table gather outweighs the ~5-10%
                                      # iteration saving on SFS-dense reads)

    def __post_init__(self) -> None:
        self.min_sv_length = max(25, self.min_sv_length)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
