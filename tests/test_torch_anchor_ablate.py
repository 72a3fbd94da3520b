"""The one-shot anchor engine's timing probes (``batch_search_anchor(
ablate=)``) and the last pieces of the JAX package's streaming and
batch API, on the CPU:

- ``""``, ``key``, ``noexit`` and ``noexit,key`` of the port's plain
  version against anchor_jax.batch_search_anchor with the same string, in
  all six result fields and the per-lane stop rounds (debug_hist);
- ``noexit`` against the un-probed search: every field but ``iters``
  (= max_rounds), the stop rounds and the work counts;
- ``read``, ``text``, ``funnel`` and combinations (the port's own
  definitions, which differ from JAX's nibble arithmetic) against the K3
  lane mirror of tests/test_torch_anchor_lanes.py, with the work counts
  and the stop rounds, on a read mix and on chip_smoke.lane_edge_case's
  reads;
- AnchorPool.run / occupied against the JAX pool's, and
  _DeviceSearcher.search_batch against the JAX package's.

Integer results: equality is exact."""

import numpy as np
import pytest
import torch

import chip_smoke
from svdss_tpu.config import Config as JConfig
from svdss_tpu.index.fmd import build_index as j_build_index
from svdss_tpu.index.fmd import genome_text as j_genome_text
from svdss_tpu.ops import anchor_jax
from svdss_tpu.ops.anchor import build_anchor_index as j_build_anchor_index
from svdss_tpu.ops.anchor_pool import AnchorPool as JaxPool
from svdss_tpu.ops.pingpong_jax import pack_reads as j_pack_reads
from svdss_tpu.pipeline import search as j_search
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.index.fmd import build_index, genome_text
from svdss_tpu_torch.ops.anchor import build_anchor_index
from svdss_tpu_torch.ops.anchor_device import (ABL_FUNNEL, ABL_KEY,
                                               ABL_NOEXIT, ABL_READ,
                                               ABL_TEXT, ABLATIONS,
                                               ablate_mask,
                                               batch_search_anchor,
                                               from_arrays)
from svdss_tpu_torch.ops.anchor_pool import AnchorPool
from svdss_tpu_torch.pipeline import search

from test_torch_anchor import corpus, random_genome, tables
from test_torch_anchor_lanes import Tables, mirror_batch
from test_torch_anchor_lanes import run_lane as k3_lane
from test_torch_anchor_pool import make_reads

# the suite runs test files in parallel processes: a torch thread pool
# in each only oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")
CAP, MAX_ROUNDS = 16, 700


@pytest.fixture(scope="module")
def mix():
    """A 20 kb random genome and test_torch_anchor's read mix on it: with
    cap 16 and 700 rounds some lanes overflow and some end incomplete."""
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 20_000)
    jdev, jparams, tdev, tparams, _ = tables(genome, cmax=16)
    seqs, lens = j_pack_reads(corpus(rng, genome))
    return dict(genome=genome, jdev=jdev, jparams=jparams, tdev=tdev,
                tparams=tparams, seqs=np.array(seqs), lens=np.array(lens))


@pytest.fixture(scope="module")
def edge():
    """chip_smoke.lane_edge_case's genome and reads (the card check's)."""
    g, cmax, reads = chip_smoke.lane_edge_case()
    jdev, jparams = anchor_jax.build_device_anchor(
        j_build_anchor_index(j_genome_text({"e": g}), cmax=cmax))
    tdev, tparams = from_arrays(np.asarray(jdev.small),
                                np.asarray(jdev.text_words), jparams, "cpu")
    seqs, lens = j_pack_reads(reads)
    return dict(tdev=tdev, tparams=tparams, seqs=np.array(seqs),
                lens=np.array(lens))


def port(case, ablate, cap=CAP, max_rounds=MAX_ROUNDS):
    """(result, done_r, work) of the port's plain version."""
    work = torch.zeros(4, dtype=torch.int64)
    res, done_r = batch_search_anchor(
        case["tdev"], case["tparams"], torch.from_numpy(case["seqs"]),
        torch.from_numpy(case["lens"]), cap=cap, max_rounds=max_rounds,
        work=work, debug_hist=True, ablate=ablate)
    return res, done_r.numpy(), work.tolist()


def mirror_done_r(case, cap, max_rounds, mask):
    """K3's done_r by its own rule (a lane that stopped did so at its last
    round count), on the warp mirror of its lane under the probe mask."""
    T = Tables(case["tdev"], case["tparams"])
    seqs, lens = case["seqs"], case["lens"]
    Q, Lp1 = seqs.shape
    out = np.full(Q, -1, np.int32)
    for q in range(Q):
        _, _, r, _, fb, active, _ = k3_lane(
            T, seqs[q], Lp1, int(lens[q]), (Lp1 + 63) // 64, cap,
            max_rounds, None, -1, [], mask)
        if r > 0 and (fb or not active):
            out[q] = r
    return out


def test_ablate_mask_follows_jax_substring_rule():
    assert ablate_mask("") == 0
    assert ablate_mask("noexit,key") == ABL_NOEXIT | ABL_KEY
    assert ablate_mask("read,key,text,funnel") == (ABL_READ | ABL_KEY
                                                   | ABL_TEXT | ABL_FUNNEL)
    assert ablate_mask(",".join(ABLATIONS)) == 31
    # any string: a word counts wherever it occurs, others are ignored
    assert ablate_mask("textfunnel!") == ABL_TEXT | ABL_FUNNEL
    assert ablate_mask("nothing here") == 0


@pytest.mark.parametrize("ablate", ["", "key", "noexit", "noexit,key"])
def test_plain_matches_jax(mix, ablate):
    """The probes that the port's layout lets equal JAX's do, in every
    field and stop round."""
    want, want_r = anchor_jax.batch_search_anchor(
        mix["jdev"], mix["jparams"], mix["seqs"], mix["lens"], cap=CAP,
        max_rounds=MAX_ROUNDS, debug_hist=True, ablate=ablate)
    got, got_r, _ = port(mix, ablate)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert np.array_equal(got_r, np.asarray(want_r))
    if "noexit" in ablate:
        assert int(got.iters) == MAX_ROUNDS
    # the case reaches the host flags
    assert bool(got.overflow.any()) and not bool(got.overflow.all())


@pytest.mark.parametrize("probe", ["", "key", "read,text,funnel"])
def test_noexit_changes_only_iters(mix, probe):
    """noexit runs exactly max_rounds rounds and changes nothing else: the
    fields, the stop rounds and the work counts of the search without it."""
    base, base_r, base_w = port(mix, probe)
    got, got_r, got_w = port(mix, probe + ",noexit")
    assert int(base.iters) < MAX_ROUNDS == int(got.iters)
    for f in FIELDS[:-1]:
        assert torch.equal(getattr(got, f), getattr(base, f)), f
    assert np.array_equal(got_r, base_r)
    assert got_w == base_w


# the probes held against the lane mirror: each alone, and combinations
MIRRORED = ["read", "text", "funnel", "text,funnel", "read,key",
            "read,key,text,funnel", "noexit,key", "noexit,read,text"]


@pytest.mark.parametrize("ablate", MIRRORED)
def test_plain_matches_lane_mirror(mix, ablate):
    """The port's probes (defined in batch_search_anchor_plain) equal the
    kernel's warp-per-read round under the same mask: six fields, work
    counts and stop rounds."""
    mask = ablate_mask(ablate)
    got, got_r, work = port(mix, ablate)
    want, want_work, _ = mirror_batch(
        Tables(mix["tdev"], mix["tparams"]), mix["seqs"], mix["lens"], CAP,
        MAX_ROUNDS, ablate=mask)
    for f, w in zip(FIELDS, want):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(w)), f
    assert work == want_work.tolist()
    assert np.array_equal(got_r, mirror_done_r(mix, CAP, MAX_ROUNDS, mask))
    if mask & ABL_TEXT:
        assert work[2] == 0          # no text row is read
    # the probes change the search but keep lanes running
    base, _, base_w = port(mix, "")
    assert work != base_w and work[0] > len(mix["lens"])


@pytest.mark.parametrize("ablate", ["read,key,text,funnel", "funnel",
                                    "noexit,key"])
def test_edge_reads_match_lane_mirror(edge, ablate):
    """The same on the card check's edge reads (verify rounds of 0, 1 and
    128 symbols, rows across the stride, text ends, heavy keys)."""
    mask = ablate_mask(ablate)
    max_rounds = 160
    got, got_r, work = port(edge, ablate, cap=128, max_rounds=max_rounds)
    want, want_work, _ = mirror_batch(
        Tables(edge["tdev"], edge["tparams"]), edge["seqs"], edge["lens"],
        128, max_rounds, ablate=mask)
    for f, w in zip(FIELDS, want):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(w)), f
    assert work == want_work.tolist()
    assert np.array_equal(got_r, mirror_done_r(edge, 128, max_rounds, mask))


def test_pool_run_and_occupied_match_jax(mix):
    """AnchorPool.run yields (ordinal, result) for every read, as the JAX
    pool's run does, with the same results; `occupied` is the reads in
    flight in both, and 0 once run ends."""
    genome = {"c1": mix["genome"]["c1"]}
    reads = make_reads(np.random.default_rng(41), genome, 30, 300, 4)
    jpool = JaxPool(mix["jdev"], mix["jparams"], lanes=4, read_len=300,
                    cap=CAP, rounds_per_step=40, refill=4, extract=3)
    pool = AnchorPool(mix["tdev"], mix["tparams"], lanes=4, read_len=300,
                      cap=CAP)

    def drive(p):
        out = {}
        for i, res in p.run(iter(reads)):
            assert i not in out
            out[i] = res
            assert p.occupied == p.in_flight
        assert p.occupied == 0 and p.queued == 0
        return out
    assert pool.occupied == jpool.occupied == 0
    got, want = drive(pool), drive(jpool)
    assert sorted(got) == list(range(len(reads)))
    assert got == want
    assert any(v is None for v in got.values()) and any(got.values())


@pytest.mark.parametrize("engine", ["anchor", "fm"])
def test_search_batch_matches_jax(mix, engine):
    """_DeviceSearcher.search_batch: one batch from launch to per-read SFS
    lists, host redos (overflow at cap 16, N reads) patched in, equal to
    the JAX package's."""
    chroms = {"c1": mix["genome"]["c1"]}
    reads = corpus(np.random.default_rng(5), mix["genome"], n=18)
    cfg = dict(engine=engine, lanes=16, max_sfs_per_read=CAP)
    aidx = build_anchor_index(genome_text(chroms)) \
        if engine == "anchor" else None
    mine = search._DeviceSearcher(build_index(chroms), Config(**cfg), "cpu",
                                  aidx)
    theirs = j_search._DeviceSearcher(
        j_build_index(chroms), JConfig(**cfg),
        j_build_anchor_index(j_genome_text(chroms)) if aidx else None)
    assert (mine.anchor is None) == (theirs.anchor is None) \
        == (engine == "fm")
    got = mine.search_batch(reads)
    mine.close()
    assert got == theirs.search_batch(reads)
    assert mine.fallbacks == theirs.fallbacks > 0
    assert all(g is not None for g in got) and sum(map(len, got)) > 0
    assert mine.search_batch([]) == []
