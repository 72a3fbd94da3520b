"""Experimental imprecise SV calls from soft-clipped reads.

Port of ``Clipper`` (clipper.cpp, enabled by ``--clipped``): per side
(left/right clips) dedup by read name, combine by exact breakpoint, drop
weight < 2, drop clips within +-1000bp of an existing SV, cluster within
1000bp; then pair left/right clips — pairs < 1000bp apart become ``<INS>``,
right-then-left gaps of 2000..50000bp with weight >= 5 become ``<DEL>``;
all flagged IMPRECISE with symbolic ALTs.

The reference's unsigned-underflow quirk (clipper.cpp:72: ``it->first - r``
wraps for positions < r, so near-origin clips never join an existing
cluster) is reproduced.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..config import Config
from ..models import SV, Clip


def remove_duplicates(clips: List[Clip]) -> List[Clip]:
    seen = set()
    out = []
    for c in clips:
        if c.name not in seen:
            seen.add(c.name)
            out.append(c)
    return out


def combine(clips: List[Clip]) -> List[Clip]:
    """Merge clips sharing an exact breakpoint (clipper.cpp:17-50)."""
    byk: Dict[Tuple[str, int], List[Clip]] = {}
    for c in clips:
        byk.setdefault((c.chrom, c.p), []).append(c)
    out = []
    for (chrom, p), group in byk.items():
        max_l = max(c.l for c in group)
        out.append(Clip("", chrom, p, max_l, group[0].starting, len(group)))
    return out


def filter_lowcovered(clips: List[Clip], w: int) -> List[Clip]:
    return [c for c in clips if c.w >= w]


def cluster(clips: List[Clip], r: int) -> List[Clip]:
    """Cluster by proximity (clipper.cpp:65-88), preserving the unsigned
    ``pos - r`` underflow semantics for pos < r."""
    clusters_by_pos: Dict[int, Clip] = {}
    for c in clips:
        found = False
        for pos, cl in clusters_by_pos.items():
            low_ok = pos >= r and pos - r <= c.p  # wraps (never matches) if pos < r
            if low_ok and c.p <= pos + r:
                found = True
                cl.l = max(cl.l, c.l)
                cl.w += c.w
        if not found:
            clusters_by_pos[c.p] = Clip(c.name, c.chrom, c.p, c.l,
                                        c.starting, c.w)
    return [clusters_by_pos[k] for k in sorted(clusters_by_pos)]


def filter_tooclose(clips: List[Clip],
                    sv_intervals: List[Tuple[int, int]]) -> List[Clip]:
    """Drop clips overlapping [sv.s - 1000, sv.e + 1000] (caller.cpp:39-41,
    clipper.cpp:90-99)."""
    ivs = sorted(sv_intervals)
    out = []
    for c in clips:
        hit = any(lo <= c.p + 1 and c.p <= hi for lo, hi in ivs)
        if not hit:
            out.append(c)
    return out


def _closest_right(clips: List[Clip], query: Clip) -> int:
    """Smallest index with position > query.p (binary_search,
    clipper.cpp:102-122 semantics)."""
    lo, hi = 0, len(clips) - 1
    if not clips:
        return -1
    res = -1
    while lo <= hi:
        m = (lo + hi) // 2
        if clips[m].p == query.p:
            return m + 1 if m + 1 < len(clips) else m
        if clips[m].p > query.p:
            res = m
            hi = m - 1
        else:
            lo = m + 1
    return res


def call_clipped(clips: List[Clip], svs: List[SV], chroms: Dict[str, str],
                 cfg: Config) -> List[SV]:
    """clipper.cpp:124-215."""
    lclips = [c for c in clips if c.starting]
    rclips = [c for c in clips if not c.starting]
    sv_iv = [(sv.s - cfg.clip_var_exclusion, sv.e + cfg.clip_var_exclusion)
             for sv in svs]

    def prep(side: List[Clip]) -> List[Clip]:
        side = remove_duplicates(side)
        side = combine(side)
        side = filter_lowcovered(side, cfg.clip_min_weight)
        side = filter_tooclose(side, sv_iv)
        side = cluster(side, cfg.clip_cluster_radius)
        side.sort(key=lambda c: c.p)
        return side

    rclips = prep(rclips)
    lclips = prep(lclips)
    out: List[SV] = []
    if not lclips or not rclips:
        return out
    for lc in lclips:
        r = _closest_right(rclips, lc)
        if r == -1:
            continue
        rc = rclips[r]
        if rc.w == 0:
            continue
        if abs(rc.p - lc.p) < cfg.clip_cluster_radius:
            s = lc.p if lc.w > rc.w else rc.p
            ln = max(lc.l, rc.l)
            refbase = chroms[lc.chrom][s:s + 1]
            w = max(lc.w, rc.w)
            out.append(SV("INS", lc.chrom, s, refbase, "<INS>", w, 0, 0, 0,
                          True, ln))
    for rc in rclips:
        li = _closest_right(lclips, rc)
        if li == -1:
            continue
        lc = lclips[li]
        if lc.w == 0:
            continue
        gap = lc.p - rc.p
        if cfg.clip_del_min_gap <= gap <= cfg.clip_del_max_gap:
            s = rc.p
            ln = lc.p - rc.p + 1
            refbase = chroms[rc.chrom][s:s + 1]
            w = max(lc.w, rc.w)
            if w >= cfg.clip_del_min_weight:
                out.append(SV("DEL", rc.chrom, s, refbase, "<DEL>", w, 0, 0,
                              0, True, ln))
    return out
