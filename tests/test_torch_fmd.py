"""The port's FMD device table and rank step against the JAX package's, on
the CPU. All values are integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops import fmd_jax
from svdss_tpu_torch.index.fmd import build_index as t_build_index
from svdss_tpu_torch.ops import fmd as tfmd


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(4242)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = {"g1": bases[rng.integers(0, 4, 6000)].tobytes().decode(),
         "g2": bases[rng.integers(0, 4, 2500)].tobytes().decode()}
    # a low-complexity stretch gives intervals wider than 128 at depth
    g["g3"] = "ACGTTGCA" * 120 + "N" * 40 + "AC" * 300
    return g


@pytest.fixture(scope="module")
def index(genome):
    return build_index(genome)


@pytest.fixture(scope="module")
def pair(index):
    jdev = fmd_jax.DeviceFMDIndex.from_host(index)
    tdev = tfmd.DeviceFMDIndex.from_host(index, device="cpu")
    return jdev, tdev


def test_host_index_copy_is_identical(genome, index):
    tidx = t_build_index(genome)
    assert tidx.n == index.n
    assert np.array_equal(tidx.C, index.C)
    assert np.array_equal(tidx.bwt_words, index.bwt_words)


def test_fused_rows_match(index, pair):
    jdev, tdev = pair
    want = fmd_jax._fused_from_host(index)
    got = tfmd.fused_from_host(index)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the JAX table is row-padded; the port's is not, rows agree
    jf = np.asarray(jdev.fused)
    assert np.array_equal(tdev.fused.numpy(), jf[:len(got)])
    assert not jf[len(got):].any()
    assert np.array_equal(tdev.C.numpy(), np.asarray(jdev.C))


def test_from_arrays_takes_the_jax_table(pair):
    jdev, tdev = pair
    t2 = tfmd.DeviceFMDIndex.from_arrays(np.asarray(jdev.fused),
                                         np.asarray(jdev.C), device="cpu")
    assert t2.fused.shape[0] >= tdev.fused.shape[0]
    assert torch.equal(t2.C, tdev.C)


def test_rank6_matches(index, pair, rng):
    jdev, tdev = pair
    pos = np.concatenate([rng.integers(0, index.n + 1, 300),
                          [0, 1, 127, 128, 129, index.n]]).astype(np.int32)
    want_j = np.asarray(fmd_jax.rank6(jdev, jnp.asarray(pos)))
    got = tfmd.rank6(tdev, torch.from_numpy(pos)).numpy()
    assert np.array_equal(got, want_j)
    assert np.array_equal(got, index.rank6(pos))


def test_lookup_C_and_comp6(pair):
    jdev, tdev = pair
    c = np.arange(8, dtype=np.int32)
    assert np.array_equal(
        tfmd.lookup_C(tdev, torch.from_numpy(c)).numpy(),
        np.asarray(fmd_jax.lookup_C(jdev, jnp.asarray(c))))
    c6 = np.arange(6, dtype=np.int32)
    assert np.array_equal(tfmd.comp6(torch.from_numpy(c6)).numpy(),
                          np.asarray(fmd_jax.comp6(jnp.asarray(c6))))


@pytest.mark.parametrize("wide_sz", [False, True])
def test_extend_rank_step_matches(index, pair, wide_sz):
    """Random (pos, sz, c, do, pend, p_rank), with sz > 128 in the second
    case so the two-step (pend) path runs on both sides."""
    jdev, tdev = pair
    rng = np.random.default_rng(99 + wide_sz)
    Q = 512
    pos = rng.integers(0, index.n, Q)
    hi_sz = 5000 if wide_sz else 129
    sz = np.minimum(rng.integers(0, hi_sz, Q), index.n - pos)
    if wide_sz:
        assert (sz > 128).sum() > Q // 2
    args = [pos.astype(np.int32), sz.astype(np.int32),
            rng.integers(0, 6, Q).astype(np.int32),
            rng.random(Q) < 0.8, rng.random(Q) < 0.3,
            rng.integers(0, 1000, Q).astype(np.int32)]
    want = fmd_jax.extend_rank_step(jdev, *[jnp.asarray(a) for a in args])
    got = tfmd.extend_rank_step(tdev, *[torch.from_numpy(a) for a in args])
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_from_host_refuses_wide_indexes(index):
    class Big:
        n = 2**31
    with pytest.raises(NotImplementedError):
        tfmd.DeviceFMDIndex.from_host(Big(), device="cpu")
