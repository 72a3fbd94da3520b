"""The port's narrow anchor-verify engine (tables, and the plain version
of the one-shot search on the CPU) against the JAX package's
anchor_jax.build_device_anchor / batch_search_anchor on the same tables and
reads, and its complete lanes against the host oracle. Integer results:
equality is exact, all six result fields."""

import dataclasses

import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import genome_text
from svdss_tpu.ops import anchor_jax
from svdss_tpu.ops.anchor import build_anchor_index as j_build_anchor_index
from svdss_tpu.ops.pingpong_jax import pack_reads as j_pack_reads
from svdss_tpu_torch.index.fmd import FMDIndex
from svdss_tpu_torch.ops.anchor import (NeedsFallback, anchor_search,
                                        build_anchor_index)
from svdss_tpu_torch.ops.anchor_device import (batch_search_anchor,
                                               build_device_anchor,
                                               from_arrays)
from svdss_tpu_torch.ops.pingpong import pack_reads
from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_nt6

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


def random_genome(rng, bp):
    return {"c1": "".join("ACGT"[i] for i in rng.integers(0, 4, bp))}


def repeat_genome(rng):
    """A 400 bp unit twelve times, then 8 kb of random sequence (the
    genome of tests/test_anchor_jax.py::test_device_repetitive_genome)."""
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    return {"c1": unit * 12 + "".join(
        "ACGT"[i] for i in rng.integers(0, 4, 8_000))}


def corpus(rng, genome, n=48, L=300):
    """The read mix of tests/test_anchor_jax.py: clean, mutated, inserted,
    reverse-complement, random and N-containing reads, plus short and
    edge reads and one exact 500 bp read."""
    enc = encode_nt6(genome["c1"])
    out = []
    for i in range(n):
        s = int(rng.integers(0, len(enc) - L))
        r = enc[s:s + L].copy()
        kind = i % 6
        if kind == 1:
            for _ in range(4):
                r[rng.integers(0, L)] = rng.integers(1, 5)
        elif kind == 2:
            at = int(rng.integers(50, L - 50))
            r = np.concatenate([r[:at], rng.integers(1, 5, 30)
                                .astype(np.uint8), r[at:]])
        elif kind == 3:
            r = revcomp_nt6(r)
            r[rng.integers(0, L)] = rng.integers(1, 5)
        elif kind == 4:
            r = rng.integers(1, 5, L).astype(np.uint8)
        elif kind == 5:
            r[rng.integers(0, L)] = 5
        out.append(r)
    out += [enc[:5].copy(), enc[-7:].copy(),
            rng.integers(1, 5, 3).astype(np.uint8), enc[100:101].copy(),
            enc[200:700].copy()]
    return out


def pack(reads):
    return pack_reads(reads, device="cpu")


def tables(genome, k=None, cmax=16):
    """(JAX device tables, JAX params, the port's tables carried across
    with from_arrays, port host AnchorIndex)."""
    text = genome_text(genome)
    jdev, jparams = anchor_jax.build_device_anchor(
        j_build_anchor_index(text, k=k, cmax=cmax))
    tdev, tparams = from_arrays(np.asarray(jdev.small),
                                np.asarray(jdev.text_words), jparams, "cpu")
    return jdev, jparams, tdev, tparams, build_anchor_index(text, k=k,
                                                            cmax=cmax)


def run_both(jdev, jparams, tdev, tparams, reads, **kw):
    seqs, lens = j_pack_reads(reads)
    want = anchor_jax.batch_search_anchor(jdev, jparams, seqs, lens, **kw)
    got = batch_search_anchor(tdev, tparams,
                              torch.from_numpy(np.array(seqs)),
                              torch.from_numpy(np.array(lens)), **kw)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    return got


@pytest.mark.parametrize("k", [None, 7])
def test_build_device_anchor_matches_jax(k):
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 9_000 if k else 30_000)
    text = genome_text(genome)
    jdev, jparams = anchor_jax.build_device_anchor(
        j_build_anchor_index(text, k=k))
    tdev, tparams = build_device_anchor(build_anchor_index(text, k=k),
                                        "cpu")
    assert np.array_equal(tdev.small.numpy(), np.asarray(jdev.small))
    assert np.array_equal(tdev.text_words.numpy(),
                          np.asarray(jdev.text_words))
    assert dataclasses.asdict(tparams) == dataclasses.asdict(jparams)
    assert len(tparams.bm_bases) == tparams.k - tparams.j0 - 1


# the JAX package's cases (tests/test_anchor_jax.py) and the forced ones:
# (genome, k, cmax, reads, read length, search keywords)
CASES = {
    "corpus": ("random", None, 16, 48, 300, {}),
    "overlap0": ("random", None, 16, 18, 200, {"overlap": 0}),
    "cap2": ("random", None, 16, 48, 300, {"cap": 2}),
    "max_rounds": ("random", None, 16, 48, 300, {"max_rounds": 40}),
    "repeats": ("repeat", None, 64, 24, 300, {}),
    "repeats_cmax2": ("repeat", None, 2, 24, 300, {}),
    "small_k": ("random_small", 7, 32, 30, 150, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_batch_search_matches_jax(case):
    kind, k, cmax, n, L, kw = CASES[case]
    rng = np.random.default_rng(10 + sorted(CASES).index(case))
    genome = (repeat_genome(rng) if kind == "repeat"
              else random_genome(rng, 9_000 if kind == "random_small"
                                 else 60_000))
    jdev, jparams, tdev, tparams, _ = tables(genome, k=k, cmax=cmax)
    reads = corpus(rng, genome, n=n, L=L)
    got = run_both(jdev, jparams, tdev, tparams, reads, **kw)
    # every case sends some lanes to the host, for its own reason
    assert bool((got.incomplete | got.overflow).any())
    if case == "cap2":
        assert int(got.overflow.sum()) > len(reads) // 2
    if case == "max_rounds":
        assert int(got.iters) == 40


@pytest.mark.parametrize("overlap", [-1, 0])
def test_complete_lanes_match_oracle(overlap):
    """Lanes the engine completes give the host oracle's SFS list (with
    overlap 0 too: the anchor engines follow the oracle there, unlike the
    JAX FM kernel); a flagged lane is one the serial anchor engine refuses,
    or one over its round budget."""
    rng = np.random.default_rng(20 + overlap)
    genome = random_genome(rng, 30_000)
    text = genome_text(genome)
    fmd = FMDIndex.from_text(text)
    aidx = build_anchor_index(text)
    tdev, tparams = build_device_anchor(aidx, "cpu")
    reads = corpus(rng, genome, n=30, L=200)
    seqs, lens = pack(reads)
    res = batch_search_anchor(tdev, tparams, seqs, lens, cap=256,
                              overlap=overlap)
    complete = 0
    for i, r in enumerate(reads):
        if bool(res.incomplete[i] | res.overflow[i]):
            try:
                anchor_search(aidx, r, overlap=overlap)
                assert int(res.iters) == 6 * (seqs.shape[1] - 1) + 64
            except NeedsFallback:
                pass
            continue
        k = int(res.n_sfs[i])
        got = list(zip(res.qs[i, :k].tolist(), res.length[i, :k].tolist()))
        assert got == ping_pong_search(fmd, r, overlap=overlap)
        complete += 1
    assert complete >= 0.6 * len(reads)


def test_budget_vector_matches_max_rounds():
    """A per-lane budget of B rounds flags exactly the lanes a global
    max_rounds of B leaves running, plus those that finish in round B
    (the pool's rule); the other lanes' results are the same."""
    rng = np.random.default_rng(31)
    genome = random_genome(rng, 30_000)
    tdev, tparams = build_device_anchor(
        build_anchor_index(genome_text(genome)), "cpu")
    seqs, lens = pack(corpus(rng, genome, n=24, L=200))
    B = 30
    capped = batch_search_anchor(tdev, tparams, seqs, lens, max_rounds=B)
    budget = torch.full(lens.shape, B, dtype=torch.int32)
    work = torch.zeros(4, dtype=torch.int64)
    budgeted = batch_search_anchor(tdev, tparams, seqs, lens,
                                   budget=budget, work=work)
    assert bool((capped.incomplete & ~budgeted.incomplete).sum() == 0)
    same = ~budgeted.incomplete
    for f in ("qs", "length", "n_sfs", "overflow"):
        assert torch.equal(getattr(capped, f)[same],
                           getattr(budgeted, f)[same])
    assert int(budgeted.iters) <= B
    rounds, rows, text_rows, syms = work.tolist()
    assert 0 < rows <= rounds and 0 < text_rows <= rounds and syms > 0


def test_plain_version_equals_itself_under_lane_padding():
    """Lanes are independent: a read's result does not depend on the
    other reads of its batch (only `iters` does)."""
    rng = np.random.default_rng(41)
    genome = random_genome(rng, 20_000)
    tdev, tparams = build_device_anchor(
        build_anchor_index(genome_text(genome)), "cpu")
    reads = corpus(rng, genome, n=12, L=200)
    seqs, lens = pack(reads)
    whole = batch_search_anchor(tdev, tparams, seqs, lens)
    for i in (0, 4, 9):
        one = batch_search_anchor(tdev, tparams, seqs[i:i + 1],
                                  lens[i:i + 1])
        for f in FIELDS[:5]:
            assert torch.equal(getattr(one, f)[0], getattr(whole, f)[i])
