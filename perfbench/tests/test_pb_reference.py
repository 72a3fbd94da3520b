"""The plain reference against the port's exact host engine on a tiny
genome, and its control against it at the cell's genome size."""

import json
import os

import numpy as np
import pytest

from perfbench import reference as R
from perfbench import traffic
from perfbench.tests.conftest import ROOT


def tiny_case(seed=1, n=300_000):
    rng = np.random.default_rng(seed)
    g = rng.integers(1, 5, n, dtype=np.uint8)
    reads = []
    for i in range(48):
        L = int(rng.integers(300, 3000))
        st = int(rng.integers(0, n - L))
        r = g[st:st + L].copy()
        if i % 3 == 0:                        # the other strand
            r = (5 - r[::-1]).astype(np.uint8)
        k = rng.integers(0, L, max(1, L // 200))
        r[k] = r[k] % 4 + 1
        if i % 4 == 0:                        # a novel insertion
            at = int(rng.integers(0, L))
            ins = rng.integers(1, 5, int(rng.integers(20, 200)),
                               dtype=np.uint8)
            r = np.concatenate([r[:at], ins, r[at:]])
        reads.append(r)
    reads += [rng.integers(1, 5, 500, dtype=np.uint8),   # all novel
              g[n - 400:].copy(), g[:400].copy(),        # the strand ends
              (5 - g[:300][::-1]).astype(np.uint8), g[1000:1010].copy()]
    return g, reads


@pytest.fixture(scope="module")
def tiny():
    from svdss_tpu_torch.index.fmd import build_index
    g, reads = tiny_case()
    chroms = {"c": traffic.NT6_ASCII[g].tobytes().decode()}
    fwd, rev = R.strand_symbols(g)
    return dict(g=g, reads=reads, index=build_index(chroms), fwd=fwd,
                pres=R.Presence.build(fwd, rev))


def test_reference_equals_the_exact_host_engine(tiny):
    from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
    got = R.sfs_lists(tiny["reads"], tiny["fwd"], tiny["pres"],
                      merged=False)
    want = [ping_pong_search(tiny["index"], r) for r in tiny["reads"]]
    assert got == want
    assert sum(len(x) for x in got) > 1000


def test_merge_equals_the_search_stages(tiny):
    from svdss_tpu_torch.models import SFS
    from svdss_tpu_torch.ops.assemble import assemble
    raw = R.sfs_lists(tiny["reads"], tiny["fwd"], tiny["pres"],
                      merged=False)
    merged = R.sfs_lists(tiny["reads"], tiny["fwd"], tiny["pres"])
    for pairs, m in zip(raw, merged):
        want = [(s.qs, s.l) for s in assemble(
            [SFS("r", q, l, 0) for q, l in pairs])]
        assert m == want


def test_presence_round_trip(tiny, tmp_path):
    path = str(tmp_path / "p.npz")
    tiny["pres"].save(path)
    back = R.Presence.load(path)
    for j in range(1, R.K + 1):
        assert np.array_equal(back.bits[j], tiny["pres"].bits[j])


def test_control_fails_at_the_cells_genome_size():
    """At chr22's length (101.6M two-strand symbols) a 14-mer is present
    by chance with probability ~0.32, so judging longer strings by their
    14-mers alone changes the lists of most reads of the mix."""
    conf = json.load(open(os.path.join(
        ROOT, "perfbench", "configs", "chr22_hifi30x.json")))
    g = traffic.reference_nt6(conf)
    mix = dict(json.load(open(os.path.join(
        ROOT, "perfbench", "traffic", "hifi_sv.json"))),
        batch_reads=12, set_batches=1)
    reads = traffic.make_reads(g, mix, 2 ** 31 + 5).reads
    fwd, rev = R.strand_symbols(g)
    pres = R.Presence.build(fwd, rev)
    want = R.sfs_lists(reads, fwd, pres)
    ctl = R.sfs_lists(reads, fwd, pres, verify=False)
    assert sum(a != b for a, b in zip(want, ctl)) >= 6
    assert all(len(w) > 0 for w in want)
