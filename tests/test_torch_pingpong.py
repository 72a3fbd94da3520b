"""The port's batch_search (plain version, on the CPU) against the JAX
package's pingpong_jax.batch_search on the same reads and the same fused
table, and against the host oracle. Integer results: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops.fmd_jax import DeviceFMDIndex as JaxIndex
from svdss_tpu.ops.pingpong_jax import batch_search as jax_search
from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
from svdss_tpu_torch.ops.pingpong import batch_search, pack_reads
from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_str

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(4242)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return {"g1": bases[rng.integers(0, 4, 4000)].tobytes().decode(),
            "g2": bases[rng.integers(0, 4, 2000)].tobytes().decode()}


@pytest.fixture(scope="module")
def tables(genome):
    index = build_index(genome)
    jdev = JaxIndex.from_host(index)
    tdev = DeviceFMDIndex.from_arrays(np.asarray(jdev.fused),
                                      np.asarray(jdev.C), device="cpu")
    return index, jdev, tdev


def read_mix(genome, rng):
    """Clean, mutated, reverse-complement, N-containing, random and
    inserted reads (the mix of tests/test_pingpong_device.py)."""
    g = genome["g1"]
    reads = []
    for trial in range(24):
        ln = int(rng.integers(120, 500))
        p = int(rng.integers(0, len(g) - ln))
        read = list(g[p:p + ln])
        for _ in range(int(rng.integers(0, 5))):
            read[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        read = "".join(read)
        if trial % 3 == 0:
            read = revcomp_str(read)
        if trial % 7 == 0:
            read = read[:50] + "N" + read[50:]
        reads.append(read)
    reads.append("".join("ACGT"[i] for i in rng.integers(0, 4, 200)))
    ins = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    reads.append(g[100:300] + ins + g[300:500])
    return [encode_nt6(r) for r in reads]


def port(tables, encoded, **kw):
    seqs, lens = pack_reads(encoded, device="cpu")
    return batch_search(tables[2], seqs, lens, **kw), seqs, lens


def both(tables, encoded, **kw):
    got, seqs, lens = port(tables, encoded, **kw)
    want = jax_search(tables[1], jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), **kw)
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.array_equal(g, w), f
    return got


def lanes(res, i):
    n = int(res.n_sfs[i])
    return list(zip(res.qs[i, :n].tolist(), res.length[i, :n].tolist()))


def assert_oracle(index, res, encoded, overlap=-1):
    """Every lane that is neither overflow nor incomplete equals the host
    oracle; returns how many lanes were checked."""
    checked = 0
    for i, enc in enumerate(encoded):
        if bool(res.overflow[i]) or bool(res.incomplete[i]):
            continue
        assert lanes(res, i) == ping_pong_search(index, enc, overlap), i
        checked += 1
    return checked


def test_read_mix_matches_jax_and_oracle(genome, tables):
    encoded = read_mix(genome, np.random.default_rng(1234))
    res = both(tables, encoded, cap=256)
    assert not res.overflow.any() and not res.incomplete.any()
    assert assert_oracle(tables[0], res, encoded) == len(encoded)


def test_overlap0_matches_oracle(genome, tables):
    """overlap=0 restarts one base left of the emitted SFS's start. The
    port re-seeds that restart from P[begin_new] and equals the oracle on
    every lane; the JAX kernel re-seeds from P[end - 1] (correct only for
    overlap -1), so it is not the yardstick here."""
    encoded = read_mix(genome, np.random.default_rng(1234))
    res, _, _ = port(tables, encoded, cap=256, overlap=0)
    assert not res.overflow.any() and not res.incomplete.any()
    assert assert_oracle(tables[0], res, encoded, overlap=0) == len(encoded)


def test_overflow_cap2(genome, tables):
    rng = np.random.default_rng(5)
    encoded = read_mix(genome, rng)[:6] + [
        encode_nt6("".join("ACGT"[i] for i in rng.integers(0, 4, 400)))]
    res = both(tables, encoded, cap=2)
    assert bool(res.overflow[-1]) and int(res.n_sfs[-1]) == 2
    assert assert_oracle(tables[0], res, encoded) >= 1


@pytest.mark.parametrize("max_iters", [5, 200])
def test_small_step_budget_incomplete(genome, tables, max_iters):
    encoded = read_mix(genome, np.random.default_rng(7))[:8]
    res = both(tables, encoded, cap=8, max_iters=max_iters)
    assert res.incomplete.any()
    assert int(res.iters) == 48 * -(-max_iters // 48)
    assert_oracle(tables[0], res, encoded)


def test_padding_lanes_and_empty_batch(genome, tables):
    """The pipeline pads batches with one-base reads and lanes of length
    0 never start: both match JAX."""
    encoded = read_mix(genome, np.random.default_rng(11))[:3]
    encoded += [np.ones(1, dtype=np.uint8)] * 5
    res = both(tables, encoded, cap=64)
    assert res.n_sfs[3:].eq(0).all()
    seqs = torch.zeros((4, 9), dtype=torch.uint8)
    res = batch_search(tables[2], seqs, torch.zeros(4, dtype=torch.int32))
    assert int(res.iters) == 0 and not res.incomplete.any()


def test_kmer_jump_not_ported(tables):
    """The k-mer jump is narrow-only, as in the JAX package (its wide
    search asserts it away): a wide table with a jump table raises, and so
    does a jump_k without a table (tests/test_torch_jump.py holds the
    narrow jump mode against the JAX package)."""
    index = build_index({"g": "ACGTTGCAAC" * 30})
    wide = DeviceFMDIndex.from_host(index, "cpu", force_wide=True)
    seqs, lens = pack_reads([np.ones(4, dtype=np.uint8)], device="cpu")
    table = torch.zeros((4 ** 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="narrow"):
        batch_search(wide, seqs, lens, jump_table=table, jump_k=4)
    with pytest.raises(ValueError):
        batch_search(tables[2], seqs, lens, jump_k=8)
