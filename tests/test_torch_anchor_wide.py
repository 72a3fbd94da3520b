"""The port's wide anchor engine, one shot (tables and the plain version
of kernel K5, on the CPU) against the JAX package's
anchor_wide_jax.batch_search_anchor_wide, in all six result fields, on the
table variants of tests/test_anchor_wide_jax.py; complete lanes also
against the host oracle. Integer results: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.ops import anchor_wide_jax as jw
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu_torch.index.fmd import build_index
from svdss_tpu_torch.ops import anchor_wide_device as aw
from svdss_tpu_torch.ops.anchor_wide import build_anchor_index_wide
from svdss_tpu_torch.ops.pingpong import pack_reads
from svdss_tpu_torch.ops.pingpong_host import ping_pong_search

from test_anchor_wide import _fwd_text, _mk_genome, _reads

# the suite runs test files in parallel processes: a torch thread pool
# in each only oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")


def repeat_family(rng, copies, unit_len, edits, tail):
    """Random flank, `copies` mutated copies of one unit, random tail."""
    unit = _mk_genome(rng, unit_len)
    parts = [_mk_genome(rng, 3_000)]
    for _ in range(copies):
        c = list(unit)
        for _ in range(edits):
            c[rng.integers(0, len(c))] = "ACGT"[rng.integers(0, 4)]
        parts.append("".join(c))
    parts.append(_mk_genome(rng, tail))
    return {"r": "".join(parts)}


def make_case(name):
    """(chroms, build kwargs, reads, search kwargs) of one case."""
    rng = np.random.default_rng(sorted(CASES).index(name) + 101)
    spec = CASES[name]
    if spec.get("repeat"):
        unit = _mk_genome(rng, 300)
        chroms = {"r": _mk_genome(rng, 5_000) + unit * 25
                  + _mk_genome(rng, 20_000)}
    elif spec.get("family"):
        chroms = repeat_family(rng, 400, 150, 6, 10_000)
    else:
        chroms = {"c1": _mk_genome(rng, spec.get("g", 40_000)),
                  "c2": _mk_genome(rng, 15_000)}
    encs = _reads(rng, chroms, spec.get("nreads", 24), spec.get("L", 600))
    if spec.get("with_n"):
        for e in encs[::5]:
            e[len(e) // 3] = 5
    return chroms, spec["build"], encs, spec.get("search", {})


CASES = {
    "sorted_cmax24": dict(build=dict(k=10, cmax=24)),
    "sorted_cmax32": dict(build=dict(k=9, cmax=32), L=500),
    "right_only": dict(build=dict(k=10, cmax=24, sort_buckets="right")),
    "cmax2000_u16": dict(family=True, build=dict(k=9, cmax=2000), L=900),
    "n_reads": dict(build=dict(k=8, cmax=16), with_n=True, L=400),
    "overlap0": dict(build=dict(k=9, cmax=32), L=400,
                     search=dict(overlap=0)),
    "overlap0_right_only": dict(build=dict(k=9, cmax=32,
                                           sort_buckets="right"), L=400,
                                search=dict(overlap=0)),
    "repeat_heavy": dict(repeat=True, build=dict(k=9, cmax=12), L=800),
    # legacy unsorted buckets: pair-verify scans in both orientations
    "unsorted": dict(build=dict(k=9, cmax=32, sort_buckets=False)),
    "unsorted_repeat": dict(repeat=True, L=800,
                            build=dict(k=9, cmax=64, sort_buckets=False)),
    "cap2_overflow": dict(build=dict(k=9, cmax=32), search=dict(cap=2)),
    "max_rounds_small": dict(build=dict(k=9, cmax=32),
                             search=dict(max_rounds=150)),
}


def port_tables(chroms, build):
    return aw.build_device_anchor_wide(
        build_anchor_index_wide(_fwd_text(chroms), **build), "cpu")


def jax_tables(chroms, build):
    return jw.build_device_anchor_wide(
        j_build_anchor_index_wide(_fwd_text(chroms), **build))


def fields(res):
    return [np.asarray(getattr(res, f)) for f in FIELDS]


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_shot_matches_jax(case):
    chroms, build, encs, kw = make_case(case)
    kw = dict(dict(cap=128), **kw)
    (dev, params), (jdev, jparams) = port_tables(chroms, build), \
        jax_tables(chroms, build)
    seqs, lens = pack_reads(encs, device="cpu")
    work = torch.zeros(4, dtype=torch.int64)
    got = aw.batch_search_anchor_wide(dev, params, seqs, lens, work=work,
                                      **kw)
    want = jw.batch_search_anchor_wide(jdev, jparams,
                                       jnp.asarray(seqs.numpy()),
                                       jnp.asarray(lens.numpy()), **kw)
    for f, g, w in zip(FIELDS, fields(got), fields(want)):
        assert g.shape == w.shape and np.array_equal(g, w), f
    assert int(work[0]) > 0 and int(work[3]) > 0
    done = ~(got.overflow | got.incomplete).numpy()
    if case == "cap2_overflow":
        assert got.overflow.any()
    elif case == "max_rounds_small":
        assert got.incomplete.any() and int(got.iters) == 150
    elif case in ("repeat_heavy", "n_reads"):
        assert got.incomplete.any()
    elif case != "unsorted_repeat":
        assert done.sum() > len(encs) // 2
    index = build_index(chroms)
    overlap = kw.get("overlap", -1)
    for i in np.flatnonzero(done):
        n = int(got.n_sfs[i])
        assert list(zip(got.qs[i, :n].tolist(), got.length[i, :n].tolist())) \
            == ping_pong_search(index, encs[i], overlap)


@pytest.mark.parametrize("build", [dict(k=9, cmax=32),
                                   dict(k=9, cmax=2000),
                                   dict(k=8, cmax=16, sort_buckets="right")],
                         ids=["u8", "u16", "right_only"])
def test_tables_match_jax(build):
    """The port's device tables hold the JAX package's arrays (the uint32
    ones as int32 bit patterns) and its format choices."""
    rng = np.random.default_rng(7)
    chroms = repeat_family(rng, 40, 200, 4, 4_000)
    chroms["n"] = _mk_genome(rng, 700) + "N" * 30 + _mk_genome(rng, 700)
    dev, params = port_tables(chroms, build)
    jdev, jparams = jax_tables(chroms, build)
    for name in jw.DeviceAnchorWide._fields:
        want = np.asarray(getattr(jdev, name))
        got = getattr(dev, name).numpy()
        assert np.array_equal(got, want.view(np.int32)
                              if want.dtype.itemsize == 4 else want), name
    for f in ("k", "j0", "cmax", "n", "bm_bases", "sorted_b", "l16",
              "right_only", "ct16"):

        assert getattr(params, f) == getattr(jparams, f), f
    assert aw.pack_text2(_fwd_text(chroms))[1].view(np.uint32).any()
