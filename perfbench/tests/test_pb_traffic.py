"""The generator: deterministic by seed, the same sizes for every seed,
and the mix's parameters kept."""

import json
import os

import numpy as np
import pytest

from perfbench import traffic
from perfbench.tests.conftest import ROOT, TINY_CONFIG, TINY_TRAFFIC

MIX = dict(TINY_TRAFFIC, batch_reads=100, set_batches=4,
           read_length={"distribution": "lognormal", "median": 15000,
                        "sigma": 0.25, "min": 5000, "max": 25000},
           svs=[{"type": "insertion", "share": 0.15, "min": 50, "max": 1000},
                {"type": "deletion", "share": 0.15, "min": 50, "max": 1000}],
           sv_margin=500)
CONFIG = dict(TINY_CONFIG, reference={"name": "c", "length_bp": 3_000_000,
                                      "seed": 9})


def test_reference_is_fixed_by_the_configuration():
    a = traffic.reference_nt6(CONFIG)
    assert np.array_equal(a, traffic.reference_nt6(CONFIG))
    assert len(a) == 3_000_000 and set(np.unique(a)) == {1, 2, 3, 4}
    chroms = traffic.reference_chroms(CONFIG, a[:10])
    assert list(chroms) == ["c"] and set(chroms["c"]) <= set("ACGT")


def test_reads_are_deterministic_by_seed():
    g = traffic.reference_nt6(CONFIG)
    big = 2 ** 31 + 12345
    a = traffic.make_reads(g, MIX, big)
    b = traffic.make_reads(g, MIX, big)
    c = traffic.make_reads(g, MIX, big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a.reads, b.reads))
    assert not all(np.array_equal(x, y) for x, y in zip(a.reads, c.reads))
    # every seed asks for the same work: the same lengths and SV sizes
    assert sorted(a.lengths) == sorted(c.lengths)
    assert sorted(a.sv_size) == sorted(c.sv_size)
    assert traffic.make_reads(g, MIX, -7).lengths.sum() == a.lengths.sum()


def test_every_batch_holds_the_plan():
    g = traffic.reference_nt6(CONFIG)
    plan = sorted(zip(*traffic.batch_plan(MIX)))
    for seed in (1, 2 ** 33 + 1):
        rs = traffic.make_reads(g, MIX, seed)
        for b in range(4):
            sl = slice(100 * b, 100 * (b + 1))
            assert sorted(zip(rs.lengths[sl], rs.sv_kind[sl],
                              rs.sv_size[sl])) == plan


def test_reads_keep_the_mix():
    g = traffic.reference_nt6(CONFIG)
    rs = traffic.make_reads(g, MIX, 11)
    n = 400
    assert len(rs.reads) == n
    assert [len(r) for r in rs.reads] == list(rs.lengths)
    assert rs.lengths.min() >= 5000 and rs.lengths.max() <= 25000
    assert abs(np.median(rs.lengths) - 15000) <= 300
    assert (rs.sv_kind == 0).sum() == 60 and (rs.sv_kind == 1).sum() == 60
    sizes = rs.sv_size[rs.sv_kind >= 0]
    assert sizes.min() >= 50 and sizes.max() <= 1000
    assert all(r.dtype == np.uint8 and r.min() >= 1 and r.max() <= 4
               for r in rs.reads)


def test_reads_come_from_the_reference():
    """A read without an SV differs from its source only at its
    substitutions (0.2% of its bases); one with a deletion joins two
    pieces of the reference; one with an insertion holds novel bases."""
    g = traffic.reference_nt6(CONFIG)
    rs = traffic.make_reads(g, dict(MIX, snv_rate=0.0), 3)
    text = g.tobytes()
    for i in range(40):
        r = rs.reads[i]
        if rs.sv_kind[i] < 0:
            assert text.find(r.tobytes()) >= 0
        else:
            head, tail = r[:400].tobytes(), r[-400:].tobytes()
            assert text.find(head) >= 0 and text.find(tail) >= 0
    rs = traffic.make_reads(g, MIX, 3)
    plain = [i for i in range(40) if rs.sv_kind[i] < 0]
    r = rs.reads[plain[0]]
    assert text.find(r.tobytes()) < 0


@pytest.mark.parametrize("mix", ["novel_ins", "hifi_sv_nopool"])
def test_the_cells_mixes_make_every_read(mix):
    """Every read of the plan is made (none shorter than its insertion
    and two margins), and each batch holds the mix's carriers."""
    t = json.load(open(os.path.join(ROOT, "perfbench", "traffic",
                                    f"{mix}.json")))
    lengths, kind, size = traffic.batch_plan(t)
    margin = t["sv_margin"]
    assert len(lengths) == t["batch_reads"] == 10000
    assert (lengths[kind >= 0] - size[kind >= 0] - 2 * margin >= 0).all()
    assert (kind >= 0).sum() == 3000 and (kind < 0).sum() == 7000
    ins = size[kind >= 0]
    if mix == "novel_ins":
        assert ins.min() >= 1000 and ins.max() <= 6000
        assert lengths.min() == 7000 and lengths.max() <= 25000
        assert 0 < (lengths == 7000).sum() <= 20     # ~0.1% clipped
        assert abs(np.median(lengths) - 15000) <= 20
    else:
        # hifi_sv's reads, with the pool off
        hifi = json.load(open(os.path.join(ROOT, "perfbench", "traffic",
                                           "hifi_sv.json")))
        assert t["pool"] is False and "pool" not in hifi
        for k in ("batch_reads", "set_batches", "read_length", "snv_rate",
                  "svs", "sv_margin", "check"):
            assert t[k] == hifi[k], k
        assert ins.min() >= 50 and ins.max() <= 1000
    g = traffic.reference_nt6(CONFIG)
    rs = traffic.make_reads(g, dict(t, set_batches=1), 2 ** 33 + 5)
    assert [len(r) for r in rs.reads] == list(rs.lengths)
    assert all(r.dtype == np.uint8 and r.min() >= 1 and r.max() <= 4
               for r in rs.reads)
