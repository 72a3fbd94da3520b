"""The port's persistent-lane AnchorPool (plain version, on the CPU)
against the JAX package's AnchorPool and its one-shot batch_search_anchor,
read by read, on the same tables and the same stream: each read's
(qs, length) list, or its needs-host flag (None), must be identical.
Completion order may differ, so results are compared by tag."""

import numpy as np
import pytest

from svdss_tpu.index.fmd import genome_text
from svdss_tpu.ops import anchor_jax
from svdss_tpu.ops.anchor import build_anchor_index
from svdss_tpu.ops.anchor_pool import AnchorPool as JaxPool
from svdss_tpu.ops.pingpong_jax import pack_reads as j_pack_reads
from svdss_tpu_torch.ops.anchor_device import from_arrays
from svdss_tpu_torch.ops.anchor_pool import AnchorPool, pool_search
from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_nt6


def make_reads(rng, genome, n, L, short=0):
    """Genome samples of L symbols (every `short`-th one of L // 2):
    mutated, inserted, reverse-complement and N-containing (the mix of
    tests/test_anchor_pool.py)."""
    enc = encode_nt6(genome["c1"])
    out = []
    for i in range(n):
        ln = L // 2 if short and i % short == 0 else L
        s = int(rng.integers(0, len(enc) - ln))
        r = enc[s:s + ln].copy()
        kind = i % 5
        if kind == 1:
            for _ in range(4):
                r[rng.integers(0, ln)] = rng.integers(1, 5)
        elif kind == 2:
            at = int(rng.integers(50, ln - 50))
            r = np.concatenate(
                [r[:at], rng.integers(1, 5, 30).astype(np.uint8), r[at:]])
        elif kind == 3:
            r = revcomp_nt6(r)
        elif kind == 4:
            r[rng.integers(0, ln)] = 5
        out.append(r[:ln])
    return out


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)
    genome = {"c1": "".join("ACGT"[i] for i in rng.integers(0, 4, 50_000))}
    jdev, jparams = anchor_jax.build_device_anchor(
        build_anchor_index(genome_text(genome), cmax=16))
    tdev, tparams = from_arrays(np.asarray(jdev.small),
                                np.asarray(jdev.text_words), jparams, "cpu")
    return genome, jdev, jparams, tdev, tparams


def one_shot(jdev, jparams, reads, cap, L):
    seqs, lens = j_pack_reads(reads, pad_to=L)
    res = anchor_jax.batch_search_anchor(jdev, jparams, seqs, lens, cap=cap)
    bad = np.asarray(res.incomplete | res.overflow)
    qs, ls, nn = (np.asarray(a) for a in (res.qs, res.length, res.n_sfs))
    return [None if bad[i] else list(zip(qs[i, :nn[i]].tolist(),
                                         ls[i, :nn[i]].tolist()))
            for i in range(len(reads))]


def run_port(pool, reads):
    """Drive the pool as the search stage does: feed, pump once M reads
    are queued, drain at the end."""
    got = {}
    for i, r in enumerate(reads):
        pool.feed(i, r)
        if pool.queued >= pool.M:
            for tag, pairs in pool.pump():
                assert tag not in got
                got[tag] = pairs
    for tag, pairs in pool.drain():
        assert tag not in got
        got[tag] = pairs
    assert pool.in_flight == 0 and pool.queued == 0
    return got


# (reads, read length, every n-th read half length, lanes, emission cap);
# a pool takes its reads in chunks of twice its lanes
CASES = {
    "more_reads_than_lanes": (37, 320, 0, 8, 64),
    "more_lanes_than_reads": (5, 256, 0, 16, 32),
    "two_lengths": (24, 400, 3, 5, 64),
    "small_cap": (20, 320, 0, 4, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_matches_jax_pool_and_one_shot(tables, case):
    genome, jdev, jparams, tdev, tparams = tables
    n, L, short, lanes, cap = CASES[case]
    rng = np.random.default_rng(7 + sorted(CASES).index(case))
    reads = make_reads(rng, genome, n, L, short)
    want = one_shot(jdev, jparams, reads, cap, L)
    jax_pool = JaxPool(jdev, jparams, lanes=lanes, read_len=L, cap=cap,
                       rounds_per_step=40, refill=4, extract=3)
    from_jax = dict(jax_pool.run(reads))
    got = run_port(AnchorPool(tdev, tparams, lanes=lanes, read_len=L,
                              cap=cap), reads)
    assert sorted(got) == list(range(n))
    for i in range(n):
        assert got[i] == from_jax[i] == want[i], i
    if case == "more_reads_than_lanes":
        assert any(v is None for v in got.values())     # N reads -> host
        assert any(v for v in got.values())
    if case == "small_cap":
        assert sum(v is None for v in got.values()) > n // 2


def test_pool_empty_stream(tables):
    _, _, _, tdev, tparams = tables
    pool = AnchorPool(tdev, tparams, lanes=4, read_len=128, cap=16)
    assert list(pool.drain()) == []
    with pytest.raises(ValueError):
        pool.feed(0, np.ones(129, dtype=np.uint8))


def test_pool_search_flags_and_budget(tables):
    """pool_search on one chunk: flag bit 1 is the fallback (an N read),
    bit 2 the overflow (cap 1), and an empty read finishes with no SFS."""
    import torch
    from svdss_tpu_torch.ops.anchor_pool import FALLBACK, OVERFLOW, \
        pack_chunk
    genome, _, _, tdev, tparams = tables
    enc = encode_nt6(genome["c1"])
    with_n = enc[1000:1300].copy()
    with_n[150] = 5
    rand = np.random.default_rng(2).integers(1, 5, 300).astype(np.uint8)
    reads = [enc[2000:2300], with_n, rand, np.zeros(0, dtype=np.uint8)]
    syms, offs, lens = (torch.from_numpy(a) for a in pack_chunk(reads))
    work = torch.zeros(4, dtype=torch.int64)
    res = pool_search(tdev, tparams, syms, offs, lens, Lp1=301, cap=1,
                      work=work)
    flags = res.flags.tolist()
    assert flags[0] == 0 and int(res.n_sfs[0]) == 0
    assert flags[1] & FALLBACK
    assert flags[2] & OVERFLOW and int(res.n_sfs[2]) == 1
    assert flags[3] == 0 and int(res.n_sfs[3]) == 0
    assert int(work[0]) > 0
