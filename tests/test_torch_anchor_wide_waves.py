"""The port's parked-phase wave driver (plain version of kernel K5, on the
CPU) against the JAX package's batch_search_anchor_wide_waves on the
repeat genome of tests/test_anchor_wide_jax.py::TestParkedPhaseWaves: all
six result fields, and every wave's parked lanes, anchors and directions
as the resolver is asked for them. Integer results: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.ops import anchor_wide_jax as jw
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu.ops.anchor_wide import make_heavy_resolver as j_resolver
from svdss_tpu_torch.ops import anchor_wide_device as aw
from svdss_tpu_torch.ops.anchor_wide import (anchor_search_wide,
                                             build_anchor_index_wide,
                                             make_heavy_resolver)
from svdss_tpu_torch.ops.pingpong import pack_reads

from test_anchor_wide import _fwd_text, _mk_genome, _reads

# the suite runs test files in parallel processes: a torch thread pool
# in each only oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


def repeat_genome(rng, copies=40, unit_len=600, spacer=800):
    """TestParkedPhaseWaves._repeat_genome: 5%-diverged copies of one unit
    between random spacers."""
    unit = _mk_genome(rng, unit_len)
    parts = [_mk_genome(rng, 3_000)]
    for _ in range(copies):
        c = list(unit)
        for _ in range(len(c) // 20):
            c[rng.integers(0, len(c))] = "ACGT"[rng.integers(0, 4)]
        parts.append("".join(c))
        parts.append(_mk_genome(rng, spacer))
    return {"r": "".join(parts)}


class Asked:
    """A resolve_phases callback that answers from the heavy store and
    records what each wave asked."""

    def __init__(self, resolver, encs, base=0):
        self.resolver, self.encs, self.base = resolver, encs, base
        self.calls = []

    def __call__(self, lanes, ancs, dirbs):
        self.calls.append((np.asarray(lanes).tolist(),
                           np.asarray(ancs).tolist(),
                           np.asarray(dirbs).tolist()))
        return np.array([self.resolver(self.encs[self.base + int(ln)],
                                       int(a), "left" if d == 1 else "right")
                         for ln, a, d in zip(lanes, ancs, dirbs)],
                        dtype=np.int32)


def both(chroms, build, encs, park_limit=16):
    text = _fwd_text(chroms)
    widx = build_anchor_index_wide(text.copy(), **build)
    jidx = j_build_anchor_index_wide(text.copy(), **build)
    dev, params = aw.build_device_anchor_wide(widx, "cpu")
    jdev, jparams = jw.build_device_anchor_wide(jidx)
    seqs, lens = pack_reads(encs, device="cpu")
    ask, jask = Asked(make_heavy_resolver(widx), encs), \
        Asked(j_resolver(jidx), encs)
    work = torch.zeros(4, dtype=torch.int64)
    got = aw.batch_search_anchor_wide_waves(dev, params, seqs, lens, ask,
                                            park_limit=park_limit, work=work)
    want = jw.batch_search_anchor_wide_waves(
        jdev, jparams, jnp.asarray(seqs.numpy()), jnp.asarray(lens.numpy()),
        jask, park_limit=park_limit)
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.array_equal(g, w), f
    assert ask.calls == jask.calls
    return got, ask, widx


def exact(widx, encs, res):
    resolver = make_heavy_resolver(widx)
    done = ~(res.overflow | res.incomplete).numpy()
    for i in np.flatnonzero(done):
        n = int(res.n_sfs[i])
        assert list(zip(res.qs[i, :n].tolist(), res.length[i, :n].tolist())) \
            == anchor_search_wide(widx, encs[i], resolver=resolver)
    return int(done.sum())


@pytest.mark.parametrize("sort", [True, "right"], ids=["sorted",
                                                        "right_only"])
def test_repeat_genome_waves_match_jax(sort):
    rng = np.random.default_rng(41)
    chroms = repeat_genome(rng)
    encs = _reads(rng, chroms, 24, 1_200)
    got, ask, widx = both(chroms, dict(k=9, cmax=12, sort_buckets=sort),
                          encs)
    assert widx.heavy_rate > 0.1
    assert len(ask.calls) >= 1
    assert exact(widx, encs, got) >= len(encs) * 7 // 8


def test_park_limit_one_matches_jax():
    rng = np.random.default_rng(43)
    chroms = repeat_genome(rng)
    encs = _reads(rng, chroms, 12, 1_000)
    got, ask, widx = both(chroms, dict(k=9, cmax=12), encs, park_limit=1)
    assert len(ask.calls) >= 1 and got.incomplete.any()
    exact(widx, encs, got)


def test_clean_genome_no_waves():
    rng = np.random.default_rng(47)
    chroms = {"c": _mk_genome(rng, 40_000)}
    encs = _reads(rng, chroms, 16, 600)
    got, ask, widx = both(chroms, dict(k=10, cmax=24), encs)
    assert ask.calls == []
    assert exact(widx, encs, got) > len(encs) // 2


def test_wave_scheduler_interleaved_matches_serial():
    """WideWaveScheduler round-robins two runs; the results equal each
    run driven alone, and the JAX package's scheduler."""
    rng = np.random.default_rng(97)
    chroms = repeat_genome(rng, copies=30, unit_len=500, spacer=700)
    encs = _reads(rng, chroms, 24, 900)
    text = _fwd_text(chroms)
    widx = build_anchor_index_wide(text.copy(), k=9, cmax=12)
    jidx = j_build_anchor_index_wide(text.copy(), k=9, cmax=12)
    dev, params = aw.build_device_anchor_wide(widx, "cpu")
    jdev, jparams = jw.build_device_anchor_wide(jidx)
    seqs, lens = pack_reads(encs, device="cpu")
    half = len(encs) // 2
    parts = [(seqs[:half], lens[:half], 0), (seqs[half:], lens[half:], half)]

    def runs():
        return [aw.WideWaveRun(dev, params, s, ln,
                               Asked(make_heavy_resolver(widx), encs, b))
                for s, ln, b in parts]

    def jruns():
        return [jw.WideWaveRun(jdev, jparams, jnp.asarray(s.numpy()),
                               jnp.asarray(ln.numpy()),
                               Asked(j_resolver(jidx), encs, b))
                for s, ln, b in parts]

    serial = [r.finish() for r in runs()]
    inter = aw.WideWaveScheduler(runs()).finish_all()
    jinter = jw.WideWaveScheduler(jruns()).finish_all()
    parked = 0
    for a, b, c in zip(serial, inter, jinter):
        for f in FIELDS:
            assert np.array_equal(getattr(a, f).numpy(),
                                  getattr(b, f).numpy()), f
            assert np.array_equal(getattr(b, f).numpy(),
                                  np.asarray(getattr(c, f))), f

    for r in runs():
        r.finish()
        parked += r.parked_lanes
    assert parked > 0
