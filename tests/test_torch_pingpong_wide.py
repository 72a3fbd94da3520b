"""The port's ping-pong FM search on a wide table (plain version, on the
CPU) against the JAX package's wide batch_search, field for field, at limb
width 31 (zero high limbs) and 15 (non-zero high limbs, as
tests/test_pingpong_wide.py runs it); and against the port's narrow search
and the host oracle. Integer results: equality is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops import fmd_jax
from svdss_tpu.ops.pingpong_jax import batch_search as jax_search
from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
from svdss_tpu_torch.ops.pingpong import batch_search, pack_reads
from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_str

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(777)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return {"w1": bases[rng.integers(0, 4, 80000)].tobytes().decode()}


@pytest.fixture(scope="module")
def index(genome):
    return build_index(genome)


@pytest.fixture(scope="module")
def reads(genome):
    """Mutated, reverse-complement, inserted and N-containing reads (the
    mix of tests/test_pingpong_wide.py) and one random read."""
    rng = np.random.default_rng(31)
    g = genome["w1"]
    out = []
    for t in range(20):
        ln = int(rng.integers(150, 600))
        p = int(rng.integers(0, len(g) - ln))
        read = list(g[p:p + ln])
        for _ in range(int(rng.integers(0, 6))):
            read[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        read = "".join(read)
        if t % 3 == 0:
            read = revcomp_str(read)
        if t % 5 == 0:
            ins = "".join("ACGT"[i] for i in rng.integers(0, 4, 40))
            read = read[:60] + ins + read[60:]
        if t % 7 == 0:
            read = read[:90] + "N" + read[91:]
        out.append(read)
    out.append("".join("ACGT"[i] for i in rng.integers(0, 4, 300)))
    return [encode_nt6(r) for r in out]


@pytest.fixture(params=[31, 15])
def limb(request, monkeypatch):
    monkeypatch.setattr(fmd_jax, "LIMB_BITS", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


@pytest.mark.parametrize("kw", [dict(cap=256), dict(cap=2),
                                dict(cap=256, max_iters=200)],
                         ids=["full", "overflow", "step-budget"])
def test_wide_search_matches_jax(index, reads, limb, kw):
    jdev = fmd_jax.DeviceFMDIndex.from_host(index, force_wide=True)
    tdev = DeviceFMDIndex.from_host(index, device="cpu", force_wide=True,
                                    limb_bits=limb)
    # the JAX table wrapped as it is reads the same
    tjax = DeviceFMDIndex.from_arrays(
        np.asarray(jdev.fused), np.asarray(jdev.C), device="cpu",
        C_hi=np.asarray(jdev.C_hi), limb_bits=limb)
    seqs, lens = pack_reads(reads, device="cpu")
    got = batch_search(tdev, seqs, lens, **kw)
    got_j = batch_search(tjax, seqs, lens, **kw)
    want = jax_search(jdev, jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), **kw)
    narrow = batch_search(DeviceFMDIndex.from_host(index, device="cpu"),
                          seqs, lens, **kw)
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.array_equal(g, w), f
        assert np.array_equal(getattr(got_j, f).numpy(), g), f
        assert np.array_equal(getattr(narrow, f).numpy(), g), f
    if kw["cap"] == 2:
        assert got.overflow.any()
    if "max_iters" in kw:
        assert got.incomplete.any()
    done = ~(got.overflow | got.incomplete).numpy()
    if len(kw) == 1 and kw["cap"] > 2:
        assert done.sum() > len(reads) // 2
    for i in np.flatnonzero(done):
        n = int(got.n_sfs[i])
        assert list(zip(got.qs[i, :n].tolist(), got.length[i, :n].tolist())) \
            == ping_pong_search(index, reads[i])
