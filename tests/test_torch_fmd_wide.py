"""The port's wide FMD table (split-limb checkpoints, int64 coordinates)
against the JAX package's wide mode, on the CPU: rows, rank, the rank step
and wrapping the JAX table. At limb width 31 the high limbs of a small
genome are zero; at 15 (the JAX package's own test setting,
tests/test_pingpong_wide.py) every count past 32k symbols has a non-zero
high limb, so the limb joins run for real. All values are integers:
equality is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops import fmd_jax
from svdss_tpu_torch.ops import fmd as tfmd

# the suite runs test files in parallel processes: a torch thread pool
# in each only oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def index():
    # 160k two-strand symbols: each symbol's count passes 2^15, and all
    # stay under the 5-bit high-limb bound of 2^20 at 15 bits
    rng = np.random.default_rng(777)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return build_index({"w1": bases[rng.integers(0, 4, 80000)]
                        .tobytes().decode()})


@pytest.fixture(params=[31, 15])
def limb(request, monkeypatch):
    """The limb width, set on the JAX side too (its functions read the
    module global at trace time, so jit caches are dropped around it)."""
    monkeypatch.setattr(fmd_jax, "LIMB_BITS", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


@pytest.fixture
def pair(index, limb):
    jdev = fmd_jax.DeviceFMDIndex.from_host(index, force_wide=True)
    tdev = tfmd.DeviceFMDIndex.from_host(index, device="cpu",
                                         force_wide=True, limb_bits=limb)
    assert jdev.wide and tdev.wide and tdev.limb_bits == limb
    return jdev, tdev


def test_fused_rows_match_wide(index, pair, limb):
    jdev, tdev = pair
    want = fmd_jax._fused_from_host(index, wide=True)
    got = tfmd.fused_from_host(index, limb)
    assert np.array_equal(got, want)
    assert np.array_equal(tdev.fused.numpy(),
                          np.asarray(jdev.fused)[:len(got)])
    assert (got[:, 6] != 0).any() == (limb < 31)
    C = np.asarray(jdev.C).astype(np.int64) \
        + (np.asarray(jdev.C_hi).astype(np.int64) << limb)
    assert tdev.C.dtype == torch.int64
    assert np.array_equal(tdev.C.numpy(), C)
    assert np.array_equal(C, index.C.astype(np.int64))


def test_rank6_wide(index, pair, rng):
    jdev, tdev = pair
    pos = np.concatenate([rng.integers(0, index.n + 1, 300),
                          [0, 1, 127, 128, 129, index.n]])
    want = np.asarray(fmd_jax.rank6(jdev, jnp.asarray(pos.astype(np.int32))))
    got = tfmd.rank6(tdev, torch.from_numpy(pos)).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(got, index.rank6(pos.astype(np.int32)))


@pytest.mark.parametrize("wide_sz", [False, True])
def test_extend_rank_step_wide(index, pair, limb, wide_sz):
    """Random (pos, sz, c, do, pend, p_rank) as limb pairs on the JAX side
    and int64 on the port's; sz > 128 in the second case so the two-step
    (pend) path runs. The port's int64 results equal the JAX limb pairs
    joined (the size as its uint32 bit pattern)."""
    jdev, tdev = pair
    rng = np.random.default_rng(99 + wide_sz)
    Q = 512
    mask = (1 << limb) - 1
    pos = rng.integers(0, index.n, Q)
    sz = np.minimum(rng.integers(0, 5000 if wide_sz else 129, Q),
                    index.n - pos)
    c = rng.integers(0, 6, Q).astype(np.int32)
    do, pend = rng.random(Q) < 0.8, rng.random(Q) < 0.3
    p_rank = rng.integers(0, index.n // 4, Q)

    def limbs(x):
        return ((x & mask).astype(np.int32), (x >> limb).astype(np.int32))
    (pos_lo, pos_hi), (pr_lo, pr_hi) = limbs(pos), limbs(p_rank)
    want = fmd_jax.extend_rank_step(
        jdev, *[jnp.asarray(a) for a in (pos_lo, sz.astype(np.int32), c, do,
                                         pend, pr_lo)],
        jnp.asarray(pos_hi), jnp.asarray(pr_hi))
    w = [np.asarray(a).astype(np.int64) for a in want]
    got = [t.numpy() for t in tfmd.extend_rank_step(
        tdev, torch.from_numpy(pos), torch.from_numpy(sz),
        torch.from_numpy(c), torch.from_numpy(do), torch.from_numpy(pend),
        torch.from_numpy(p_rank))]
    assert np.array_equal(got[0], w[0] + (w[5] << limb))        # pos
    assert np.array_equal(got[1] & 0xFFFFFFFF, w[1] & 0xFFFFFFFF)  # sz
    assert np.array_equal(got[2], w[2]) and np.array_equal(got[3], w[3])
    assert np.array_equal(got[4], w[4] + (w[6] << limb))        # p_rank
    if wide_sz:
        assert got[3].sum() > Q // 4


def test_from_arrays_takes_the_jax_wide_table(pair, limb):
    jdev, tdev = pair
    t2 = tfmd.DeviceFMDIndex.from_arrays(
        np.asarray(jdev.fused), np.asarray(jdev.C), device="cpu",
        C_hi=np.asarray(jdev.C_hi), limb_bits=limb)
    assert t2.wide and t2.limb_bits == limb
    assert torch.equal(t2.C, tdev.C)
    assert torch.equal(t2.fused[:tdev.fused.shape[0]], tdev.fused)
    if limb == 31:
        # the JAX split C alone means its production width
        t3 = tfmd.DeviceFMDIndex.from_arrays(
            np.asarray(jdev.fused), np.asarray(jdev.C), device="cpu",
            C_hi=np.asarray(jdev.C_hi))

        assert t3.limb_bits == 31 and torch.equal(t3.C, tdev.C)
