"""Partial-order-alignment consensus of cluster subreads.

Role equivalent of the reference's abPOA call (run_poa, caller.cpp:257-308):
global alignment mode, no seeding, no progressive ordering, single
consensus. Sequences are added to a growing partial-order DAG by global
convex-gap alignment with abPOA's default scores: match +2, mismatch -4,
gap cost min(4 + 2*len, 24 + 1*len) (dual affine pieces).

Consensus is the heaviest bundle (Lee 2003, abPOA's default): the
source-to-sink path maximizing summed edge support.

Alignment DP is vectorized over the sequence axis with a lazy-F fixpoint
for the in-sequence gap state; the graph axis walks nodes in topological
order. Identical-sequence clusters short-circuit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG = -(10 ** 8)

MATCH = 2
MISMATCH = -4
GAP_OPEN = 4
GAP_EXT = 2
GAP_OPEN2 = 24
GAP_EXT2 = 1


class _Graph:
    def __init__(self):
        self.base: List[str] = []
        self.preds: List[List[int]] = []
        self.succs: List[List[int]] = []
        self.node_w: List[int] = []
        self.edge_w: Dict[Tuple[int, int], int] = {}
        self.column: List[int] = []      # alignment-column id per node
        self.col_nodes: Dict[int, List[int]] = {}
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.start_w: Dict[int, int] = {}
        self._ncols = 0

    def new_node(self, b: str, col: Optional[int] = None) -> int:
        idx = len(self.base)
        self.base.append(b)
        self.preds.append([])
        self.succs.append([])
        self.node_w.append(0)
        if col is None:
            col = self._ncols
            self._ncols += 1
        self.column.append(col)
        self.col_nodes.setdefault(col, []).append(idx)
        return idx

    def add_edge(self, u: int, v: int) -> None:
        if u < 0:
            return
        if v not in self.succs[u]:
            self.succs[u].append(v)
            self.preds[v].append(u)
        self.edge_w[(u, v)] = self.edge_w.get((u, v), 0) + 1

    def topo_order(self) -> List[int]:
        n = len(self.base)
        indeg = [len(p) for p in self.preds]
        stack = [i for i in range(n) if indeg[i] == 0]
        order = []
        while stack:
            v = stack.pop()
            order.append(v)
            for s in self.succs[v]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
        assert len(order) == n, "POA graph has a cycle"
        return order

    def add_first(self, seq: str) -> None:
        prev = -1
        for ch in seq:
            v = self.new_node(ch)
            self.node_w[v] += 1
            if prev >= 0:
                self.add_edge(prev, v)
            else:
                self.starts.append(v)
                self.start_w[v] = self.start_w.get(v, 0) + 1
            prev = v
        if prev >= 0:
            self.ends.append(prev)


def _align_to_graph(g: _Graph, seq: str):
    """Global affine alignment of seq against the DAG.

    Returns the traceback as a list of (node_or_-1, seqpos_or_-1) pairs.
    """
    order = g.topo_order()
    n = len(order)
    m = len(seq)
    pos_in_order = {v: i for i, v in enumerate(order)}
    seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)

    # Row 0 is the virtual source; row i (1..n) is node order[i-1].
    H = np.full((n + 1, m + 1), NEG, dtype=np.int32)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int32)    # node gap, piece 1
    E2 = np.full((n + 1, m + 1), NEG, dtype=np.int32)   # node gap, piece 2
    F = np.full((n + 1, m + 1), NEG, dtype=np.int32)    # seq gap, piece 1
    F2 = np.full((n + 1, m + 1), NEG, dtype=np.int32)   # seq gap, piece 2
    jj = np.arange(1, m + 1, dtype=np.int32)
    H[0, 0] = 0
    H[0, 1:] = -np.minimum(GAP_OPEN + GAP_EXT * jj,
                           GAP_OPEN2 + GAP_EXT2 * jj)
    oe = GAP_OPEN + GAP_EXT
    oe2 = GAP_OPEN2 + GAP_EXT2

    def row_preds(v: int) -> List[int]:
        ps = [pos_in_order[u] + 1 for u in g.preds[v]]
        if v in g.starts or not ps:
            ps = ps + [0]
        return ps

    for i in range(1, n + 1):
        v = order[i - 1]
        b = ord(g.base[v])
        sub = np.where(seq_arr == b, np.int32(MATCH), np.int32(MISMATCH))
        best_h = np.full(m + 1, NEG, dtype=np.int32)
        best_e = np.full(m + 1, NEG, dtype=np.int32)
        best_e2 = np.full(m + 1, NEG, dtype=np.int32)
        for pi in row_preds(v):
            hp = H[pi]
            # diagonal: consume node + seq char
            cand = np.full(m + 1, NEG, dtype=np.int32)
            cand[1:] = hp[:-1] + sub
            best_h = np.maximum(best_h, cand)
            # E: consume node only (deletion in seq), both gap pieces
            best_e = np.maximum(best_e,
                                np.maximum(hp - oe, E[pi] - GAP_EXT))
            best_e2 = np.maximum(best_e2,
                                 np.maximum(hp - oe2, E2[pi] - GAP_EXT2))
        E[i] = best_e
        E2[i] = best_e2
        Hrow = np.maximum(best_h, np.maximum(best_e, best_e2))
        # lazy-F fixpoint over both pieces:
        # F[i, j] = max_k<j (H[i, k] - piece-cost(j - k))
        kk = np.arange(m + 1, dtype=np.int32)
        Fv = np.full(m + 1, NEG, dtype=np.int32)
        F2v = np.full(m + 1, NEG, dtype=np.int32)
        for _ in range(m + 1):
            run = np.maximum.accumulate(Hrow - GAP_OPEN + GAP_EXT * kk)
            Fv = np.full(m + 1, NEG, dtype=np.int32)
            Fv[1:] = run[:-1] - GAP_EXT * jj
            run2 = np.maximum.accumulate(Hrow - GAP_OPEN2 + GAP_EXT2 * kk)
            F2v = np.full(m + 1, NEG, dtype=np.int32)
            F2v[1:] = run2[:-1] - GAP_EXT2 * jj
            new_H = np.maximum(Hrow, np.maximum(Fv, F2v))
            if np.array_equal(new_H, Hrow):
                break
            Hrow = new_H
        F[i] = Fv
        F2[i] = F2v
        H[i] = Hrow

    # pick best end: global over end nodes (virtual sink)
    end_rows = [pos_in_order[v] + 1 for v in g.ends] or [0]
    best_row = max(end_rows, key=lambda r: H[r, m])

    # traceback by score equality
    path: List[Tuple[int, int]] = []  # (node, seqpos) with -1 for gap
    i, j = best_row, m
    state = "H"
    guard = 0
    while (i > 0 or j > 0) and guard < 10 * (n + m + 2):
        guard += 1
        if state == "H":
            if i == 0:
                path.append((-1, j - 1))
                j -= 1
                continue
            v = order[i - 1]
            hv = H[i, j]
            if hv == F[i, j]:
                state = "F"
                continue
            if hv == F2[i, j]:
                state = "F2"
                continue
            if hv == E[i, j]:
                state = "E"
                continue
            if hv == E2[i, j]:
                state = "E2"
                continue
            moved = False
            if j > 0:
                b = g.base[v]
                s = MATCH if seq[j - 1] == b else MISMATCH
                for pi in row_preds(v):
                    if H[pi, j - 1] + s == hv:
                        path.append((v, j - 1))
                        i, j = pi, j - 1
                        moved = True
                        break
            if not moved:
                # numerical fallback: treat as deletion of the node
                state = "E"
        elif state in ("E", "E2"):
            Em = E if state == "E" else E2
            ext = GAP_EXT if state == "E" else GAP_EXT2
            open_cost = oe if state == "E" else oe2
            v = order[i - 1]
            path.append((v, -1))
            done = False
            for pi in row_preds(v):
                if Em[i, j] == Em[pi, j] - ext:
                    i = pi
                    done = True
                    break
            if not done:
                for pi in row_preds(v):
                    if Em[i, j] == H[pi, j] - open_cost:
                        i = pi
                        state = "H"
                        done = True
                        break
            if not done:
                i = row_preds(v)[0]
                state = "H"
        else:  # F / F2: gap consuming seq chars
            Fm = F if state == "F" else F2
            ext = GAP_EXT if state == "F" else GAP_EXT2
            path.append((-1, j - 1))
            if j >= 2 and Fm[i, j] == Fm[i, j - 1] - ext:
                j -= 1
            else:
                j -= 1
                state = "H"
    path.reverse()
    return path


def _merge(g: _Graph, seq: str, path) -> None:
    prev = -1
    first_used = None
    used_last = -1
    for node, spos in path:
        if spos == -1:
            continue  # node deleted in this sequence: no node used
        ch = seq[spos]
        if node == -1:
            u = g.new_node(ch)
        else:
            if g.base[node] == ch:
                u = node
            else:
                u = None
                for w in g.col_nodes[g.column[node]]:
                    if g.base[w] == ch:
                        u = w
                        break
                if u is None:
                    u = g.new_node(ch, col=g.column[node])
        g.node_w[u] += 1
        if prev >= 0:
            g.add_edge(prev, u)
        else:
            if u not in g.starts:
                g.starts.append(u)
            g.start_w[u] = g.start_w.get(u, 0) + 1
            first_used = u
        prev = u
        used_last = u
    if used_last >= 0 and used_last not in g.ends:
        g.ends.append(used_last)
    del first_used


def _consensus(g: _Graph) -> str:
    """Heaviest bundle, abPOA-style: at every node greedily follow the
    out-edge with the largest read support (ties by downstream score), so a
    minority insertion branch loses to the heavier skip edge regardless of
    its length."""
    order = g.topo_order()
    score: Dict[int, int] = {}
    choice: Dict[int, int] = {}
    for v in reversed(order):
        best_w, best_s, best_u = -1, -1, -1
        for u in g.succs[v]:
            w = g.edge_w[(v, u)]
            if (w, score[u]) > (best_w, best_s):
                best_w, best_s, best_u = w, score[u], u
        if best_u == -1:
            score[v] = 0
            choice[v] = -1
        else:
            score[v] = best_w + best_s
            choice[v] = best_u
    v = max(g.starts, key=lambda s: (g.start_w.get(s, 0), score[s]))
    out = []
    while v != -1:
        out.append(g.base[v])
        v = choice[v]
    return "".join(out)


def poa_consensus(seqs: Sequence[str]) -> str:
    """Consensus of a list of sequences (cf. run_poa, caller.cpp:257-308)."""
    seqs = [s for s in seqs if s]
    if not seqs:
        return ""
    if len(set(seqs)) == 1:
        return seqs[0]
    g = _Graph()
    g.add_first(seqs[0])
    for s in seqs[1:]:
        path = _align_to_graph(g, s)
        _merge(g, s, path)
    return _consensus(g)
