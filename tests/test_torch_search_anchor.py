"""The port's search stage with the anchor engine (one-shot and pool, the
kernels' plain versions on the CPU) against the JAX package's run_search
and the host engines; its engine gate against the JAX package's
_DeviceSearcher; and `cli run --engine anchor` against `svdss_tpu.cli run
--no-device`. Outputs are compared exactly."""

import dataclasses
import os
import types

import numpy as np
import pytest

from svdss_tpu import cli as jax_cli
from svdss_tpu.config import Config as JConfig
from svdss_tpu.index.fmd import build_index as j_build_index
from svdss_tpu.index.fmd import genome_text as j_genome_text
from svdss_tpu.ops import fmd_jax
from svdss_tpu.ops.anchor import build_anchor_index as j_build_anchor_index
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu.pipeline import search as j_search
from svdss_tpu_torch import cli
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.index.fmd import build_index, genome_text
from svdss_tpu_torch.io.fasta import write_fasta
from svdss_tpu_torch.ops.anchor import AnchorIndex, build_anchor_index
from svdss_tpu_torch.ops.anchor_wide import build_anchor_index_wide
from svdss_tpu_torch.pipeline import search
from svdss_tpu_torch.pipeline.search import run_search
from svdss_tpu_torch.pipeline.smooth import run_smooth
from svdss_tpu_torch.utils.seq import encode_nt6
from svdss_tpu_torch.utils.simulate import (make_haplotype, random_genome,
                                            simulate_reads, write_bam)

DEV = dict(use_device=True, lanes=16, max_sfs_per_read=128)


def norm(groups):
    return [(q, [(s.qs, s.l, s.htag) for s in g]) for q, g in groups]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """The sample of tests/test_search_pipeline.py, with both packages'
    indexes and anchor tables."""
    rng = np.random.default_rng(777)
    tmp = tmp_path_factory.mktemp("tanchor")
    chroms = random_genome(rng, {"chrS": 40000})
    hap1 = make_haplotype(rng, "chrS", chroms["chrS"], n_ins=2, n_del=2,
                          min_len=60, max_len=150)
    hap2 = make_haplotype(rng, "chrS", chroms["chrS"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [hap1, hap2], coverage=8, read_len=2000,
                          snv_rate=0.002, indel_rate=0.0005)
    bam = tmp / "reads.bam"
    write_bam(str(bam), chroms, recs)
    smoothed = tmp / "smoothed.bam"
    run_smooth(Config(use_device=False), chroms, str(bam), str(smoothed))
    return dict(chroms=chroms, smoothed=str(smoothed),
                index=build_index(chroms), jindex=j_build_index(chroms),
                anchor=build_anchor_index(genome_text(chroms)),
                janchor=j_build_anchor_index(j_genome_text(chroms)))


@pytest.mark.parametrize("pool", [True, False])
def test_run_search_anchor_matches_jax_and_host(sample, pool, caplog):
    caplog.set_level("INFO", logger="svdss_tpu")
    got = run_search(Config(engine="anchor", pool=pool, **DEV),
                     sample["index"], bam=sample["smoothed"], device="cpu",
                     anchor=sample["anchor"])
    log = " ".join(r.getMessage() for r in caplog.records)
    assert "anchor engine on cpu" in log
    assert ("anchor pool on cpu" in log) == pool
    want = j_search.run_search(JConfig(engine="anchor", pool=pool, **DEV),
                               sample["jindex"], bam=sample["smoothed"],
                               anchor=sample["janchor"])
    host = run_search(Config(use_device=False), sample["index"],
                      bam=sample["smoothed"])
    assert norm(got) == norm(want) == norm(host)
    assert sum(len(g) for _, g in got) > 0


def test_run_search_anchor_host_redo(sample, tmp_path, caplog):
    """SFS-dense random reads overflow the pool's cap and reads with an N
    fall back; both are redone on the host, and the output still equals
    the JAX package's pool and the host engines."""
    g = sample["chroms"]["chrS"]
    rng = np.random.default_rng(8)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as fh:
        for k in range(12):
            if k % 3 == 0:
                s = "".join("ACGT"[i] for i in rng.integers(0, 4, 900))
            else:
                p = int(rng.integers(0, len(g) - 900))
                s = g[p:p + 450] + ("N" if k % 3 == 1 else "") \
                    + g[p + 450:p + 900]
            fh.write(f"@r{k}\n{s}\n+\n{'I' * len(s)}\n")
    caplog.set_level("INFO", logger="svdss_tpu")
    got = run_search(Config(engine="anchor", **DEV), sample["index"],
                     fastx=str(fq), device="cpu", anchor=sample["anchor"])
    redo = [r.getMessage() for r in caplog.records
            if "host fallbacks" in r.getMessage()]
    assert redo and not redo[-1].endswith(" 0 host fallbacks")
    want = j_search.run_search(JConfig(engine="anchor", **DEV),
                               sample["jindex"], fastx=str(fq),
                               anchor=sample["janchor"])
    host = run_search(Config(use_device=False), sample["index"],
                      fastx=str(fq))
    assert norm(got) == norm(want) == norm(host)


class BigN:
    """An index whose symbol count reads as `n` (the gate looks only at
    that); everything else is the real index's."""

    def __init__(self, index, n):
        self._index = index
        self.n = n

    def __getattr__(self, name):
        return getattr(self._index, name)


def jax_engine(index, anchor, engine):
    try:
        s = j_search._DeviceSearcher(index, JConfig(engine=engine), anchor)
    except NotImplementedError:
        return "error"
    if s.anchor is None:
        return "fm"
    return "wide" if s.wide else "anchor"


def port_engine(index, anchor, engine):
    try:
        s = search._DeviceSearcher(index, Config(engine=engine), "cpu",
                                   anchor)
    except NotImplementedError:
        return "error"
    if s.anchor is None:
        return "fm"
    return "wide" if s.wide else "anchor"


@pytest.fixture
def no_fm_tables(monkeypatch):
    """The gate is the subject here: skip building FM device tables (the
    `BigN` index has no table of its size)."""
    monkeypatch.setattr(fmd_jax.DeviceFMDIndex, "from_host",
                        classmethod(lambda cls, idx, *a, **kw: "fm"))
    monkeypatch.setattr(search.DeviceFMDIndex, "from_host",
                        classmethod(lambda cls, idx, *a, **kw:
                                    types.SimpleNamespace(nbytes=0)))


# (symbols, heavy rate, engine, expected)
NARROW = [
    ("small", 0.01, "auto", "fm"),
    ("small", 0.01, "anchor", "anchor"),
    ("big", 0.01, "auto", "anchor"),
    ("big", 0.10, "auto", "fm"),
    ("big", 0.10, "anchor", "anchor"),
    ("big", 0.01, "fm", "fm"),
    ("big", None, "auto", "fm"),
]


@pytest.mark.parametrize("size,heavy,engine,expected", NARROW)
def test_engine_gate_narrow_matches_jax(sample, no_fm_tables, size, heavy,
                                        engine, expected):
    n = 1 << 26 if size == "big" else None
    index = BigN(sample["index"], n) if n else sample["index"]
    jindex = BigN(sample["jindex"], n) if n else sample["jindex"]
    anchor = janchor = None
    if heavy is not None:
        anchor = dataclasses.replace(sample["anchor"], heavy_rate=heavy)
        janchor = dataclasses.replace(sample["janchor"], heavy_rate=heavy)
    assert port_engine(index, anchor, engine) \
        == jax_engine(jindex, janchor, engine) == expected


@pytest.fixture(scope="module")
def wide_tables(sample):
    fwd = encode_nt6(sample["chroms"]["chrS"])
    return build_anchor_index_wide(fwd), j_build_anchor_index_wide(fwd)


@pytest.mark.parametrize("heavy,expected", [(0.0, "wide"), (0.2, "fm")])
def test_engine_gate_wide_matches_jax(sample, no_fm_tables, wide_tables,
                                      heavy, expected, caplog):
    """Wide tables go through the cost model either way, and the port takes
    the engine the JAX package takes: the wide anchor engine where the
    model prefers it, else FM with the model's numbers in the log."""
    wide, jwide = (dataclasses.replace(t, heavy_rate=heavy)
                   for t in wide_tables)
    assert search.wide_engine_cost(wide) == j_search.wide_engine_cost(jwide)
    big = 1 << 26
    caplog.set_level("INFO", logger="svdss_tpu")
    assert port_engine(BigN(sample["index"], big), wide, "auto") \
        == jax_engine(BigN(sample["jindex"], big), jwide, "auto") == expected
    log = " ".join(r.getMessage() for r in caplog.records)
    assert ("wide anchor engine on cpu" in log) == (expected == "wide")
    assert ("engine cost model picks FM" in log) == (expected == "fm")


def test_engine_gate_wide_anchor_raises(sample, no_fm_tables, wide_tables):
    """`--engine anchor` on wide tables runs the wide anchor engine, as in
    the JAX package, whatever the size and the cost model say."""
    costly = [dataclasses.replace(t, heavy_rate=0.2) for t in wide_tables]
    for n in (None, 1 << 26):
        index = BigN(sample["index"], n) if n else sample["index"]
        jindex = BigN(sample["jindex"], n) if n else sample["jindex"]
        assert port_engine(index, costly[0], "anchor") \
            == jax_engine(jindex, costly[1], "anchor") == "wide"


def test_cli_run_wide_genome(tmp_path, monkeypatch, caplog):
    """A genome that takes wide anchor tables (here by the JAX package's
    switch): `run` builds them, and `run --engine anchor` searches with the
    wide anchor engine; both give the host engines' output."""
    rng = np.random.default_rng(5)
    chroms = random_genome(rng, {"chrW": 30000})
    h1 = make_haplotype(rng, "chrW", chroms["chrW"], n_ins=1, n_del=1,
                        min_len=60, max_len=120)
    recs = simulate_reads(rng, [h1, h1], coverage=6, read_len=2000)
    ref, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(ref, chroms)
    write_bam(bam, chroms, recs)
    monkeypatch.setenv("SVDSS_TPU_WIDE_ANCHOR", "1")
    common = ["--reference", ref, "--bam", bam, "--device", "cpu",
              "--lanes", "16", "--threads", "2"]
    auto_wd, anchor_wd, host_wd = (tmp_path / d for d in
                                   ("auto", "anchor", "host"))
    assert cli.main(["run", "--workdir", str(auto_wd), *common]) == 0
    with np.load(auto_wd / "index.fmd.npz.anchor.npz") as z:
        assert "cnts" in z.files            # the wide tables' field
    caplog.set_level("INFO", logger="svdss_tpu")
    assert cli.main(["run", "--workdir", str(anchor_wd), "--engine",
                     "anchor", *common]) == 0
    assert "wide anchor engine on cpu" in caplog.text
    assert cli.main(["run", "--workdir", str(host_wd), "--no-device",
                     *common]) == 0
    for name in ("specifics.txt", "variations.vcf"):
        want = (host_wd / name).read_bytes()
        assert len(want) > 0
        assert (auto_wd / name).read_bytes() == want
        assert (anchor_wd / name).read_bytes() == want


def test_cli_run_anchor_matches_jax_host_run(tmp_path):
    """`run --device cpu --engine anchor` of the port (pool, then the
    one-shot path on the same index) == `svdss_tpu.cli run --no-device`,
    byte for byte, on the tests/run-pipeline.sh sample; `run` writes the
    anchor tables, and `index` writes them unless --engine fm."""
    rng = np.random.default_rng(12)
    chroms = random_genome(rng, {"chrZ": 80000})
    h1 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=2, n_del=2,
                        min_len=60, max_len=180)
    h2 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [h1, h2], coverage=12, read_len=2500)
    ref, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(ref, chroms)
    write_bam(bam, chroms, recs)
    pool_wd, oneshot_wd, jax_wd = (tmp_path / d for d in
                                   ("pool", "oneshot", "jax"))
    common = ["--reference", ref, "--bam", bam, "--device", "cpu",
              "--engine", "anchor", "--lanes", "16", "--threads", "2"]
    assert cli.main(["run", "--workdir", str(pool_wd), *common]) == 0
    anchor_path = pool_wd / "index.fmd.npz.anchor.npz"
    assert isinstance(AnchorIndex.load(str(anchor_path)), AnchorIndex)
    os.makedirs(oneshot_wd)
    for f in ("index.fmd.npz", "index.fmd.npz.anchor.npz", "smoothed.bam"):
        os.link(pool_wd / f, oneshot_wd / f)
    assert cli.main(["run", "--workdir", str(oneshot_wd), "--no-pool",
                     *common]) == 0
    assert jax_cli.main(["run", "--reference", ref, "--bam", bam,
                         "--workdir", str(jax_wd), "--no-device",
                         "--threads", "2"]) == 0
    for name in ("specifics.txt", "variations.vcf"):
        want = (jax_wd / name).read_bytes()
        assert len(want) > 0
        assert (pool_wd / name).read_bytes() == want
        assert (oneshot_wd / name).read_bytes() == want
    idx = str(tmp_path / "i.npz")
    assert cli.main(["index", "--reference", ref, "--index", idx,
                     "--engine", "fm"]) == 0
    assert not os.path.exists(idx + ".anchor.npz")
    assert cli.main(["index", "--reference", ref, "--index", idx]) == 0
    assert os.path.exists(idx + ".anchor.npz")
