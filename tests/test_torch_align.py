"""The port's wavefront DP (plain version, on the CPU) against the JAX
package's align_jax._wavefront (whole trace and scores), and the port's
batch_align against align_pallas.batch_align_pallas (interpret mode) and
the host align_dual_gap. Integer results: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.ops import align_jax
from svdss_tpu.ops.align import DEFAULT_PARAMS, align_dual_gap
from svdss_tpu.ops.align_pallas import batch_align_pallas
from svdss_tpu_torch.ops import align_dp


def mutate(rng, t, kind, indel):
    q = list(t)
    if kind == 1:                                   # SNVs
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = int(rng.integers(1, 5))
    elif kind == 2:                                 # insertion
        at = int(rng.integers(0, len(q)))
        q[at:at] = list(rng.integers(1, 5, indel))
    elif kind == 3:                                 # deletion
        at = int(rng.integers(0, max(1, len(q) - indel)))
        del q[at:at + min(indel, len(q) - at - 1)]
    return np.array(q, dtype=np.int32)


def make_pairs(rng, n, tlo, thi, indel):
    pairs = []
    for trial in range(n):
        t = rng.integers(1, 5, int(rng.integers(tlo, thi))).astype(np.int32)
        pairs.append((mutate(rng, t, trial % 4, indel), t))
    return pairs


def padded(pairs, lq, lt):
    B = len(pairs)
    q = np.full((B, lq), -3, dtype=np.int32)
    t = np.full((B, lt), -4, dtype=np.int32)
    for b, (qa, ta) in enumerate(pairs):
        q[b, :len(qa)] = qa
        t[b, :len(ta)] = ta
    tgt_d = np.array([len(a) + len(b) for a, b in pairs], dtype=np.int32)
    tgt_i = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    return q, t, tgt_d, tgt_i


@pytest.mark.parametrize("lq,lt", [(40, 40), (64, 31), (25, 90)])
def test_wavefront_plain_matches_xla_whole_trace(lq, lt):
    rng = np.random.default_rng(lq * 1000 + lt)
    pairs = [(a[:lq], b[:lt]) for a, b in make_pairs(rng, 6, 10, lt + 1, 9)]
    pairs = [(a, b) for a, b in pairs if len(a) and len(b)]
    q, t, tgt_d, tgt_i = padded(pairs, lq, lt)
    p = DEFAULT_PARAMS
    want_tr, want_sc = align_jax._wavefront(
        *(jnp.asarray(a) for a in (q, t, tgt_d, tgt_i)), lq, lt, p.match,
        p.mismatch, p.gap_open1, p.gap_ext1, p.gap_open2, p.gap_ext2)
    got_tr, got_sc = align_dp.wavefront(
        *(torch.from_numpy(a) for a in (q, t, tgt_d, tgt_i)), lq, lt, p)
    assert got_tr.dtype == torch.uint8 and got_sc.dtype == torch.int32
    assert np.array_equal(got_tr.numpy(), np.asarray(want_tr))
    assert np.array_equal(got_sc.numpy(), np.asarray(want_sc))


def test_batch_align_matches_pallas_and_host(rng):
    pairs = make_pairs(rng, 8, 20, 90, 25)
    pairs.append((np.array([], dtype=np.int32),
                  np.array([1, 2], dtype=np.int32)))
    pairs.append((np.array([3, 1, 4], dtype=np.int32),
                  np.array([], dtype=np.int32)))
    pairs.append((np.array([], dtype=np.int32),
                  np.array([], dtype=np.int32)))
    got = align_dp.batch_align(pairs, device="cpu")
    want = batch_align_pallas(pairs)
    assert got == want
    for k, (q, t) in enumerate(pairs):
        assert got[k] == align_dual_gap(q, t), k


def test_batch_align_bucket_padding_and_long_indels():
    """pcall pads every pair to its (power-of-two) bucket; the scores and
    CIGARs do not depend on the padding."""
    rng = np.random.default_rng(31)
    pairs = make_pairs(rng, 6, 150, 220, 60)
    got = align_dp.batch_align(pairs, pad_q=256, pad_t=256, device="cpu")
    assert got == align_jax.batch_align(pairs, pad_q=256, pad_t=256)
    for k, (q, t) in enumerate(pairs):
        assert got[k] == align_dual_gap(q, t), k


def test_traceback_copy_matches():
    rng = np.random.default_rng(5)
    pairs = make_pairs(rng, 4, 30, 60, 12)
    lq = max(len(a) for a, _ in pairs)
    lt = max(len(b) for _, b in pairs)
    q, t, tgt_d, tgt_i = padded(pairs, lq, lt)
    tr, _ = align_dp.wavefront(
        *(torch.from_numpy(a) for a in (q, t, tgt_d, tgt_i)), lq, lt)
    for b, (qa, ta) in enumerate(pairs):
        assert align_dp.traceback(tr[b].numpy(), len(qa), len(ta)) == \
            align_jax._traceback(tr[b].numpy(), len(qa), len(ta))


def test_wavefront_rejects_wrong_types():
    q = torch.zeros((2, 4), dtype=torch.int64)
    t = torch.zeros((2, 4), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        align_dp.wavefront(q, t, z, z, 4, 4)
    with pytest.raises(ValueError):
        align_dp.wavefront(t, t, z, z, 4, 5)
