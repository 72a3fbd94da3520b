"""The port's search stage with the wide anchor engine (one-shot batches
and parked-phase waves, the plain version of kernel K5 on the CPU) against
the JAX package's run_search on its device path and the host engines; and
`cli run` with the JAX package's wide switch against `svdss_tpu.cli run
--no-device`. Outputs are compared exactly."""

import os

import numpy as np
import pytest

from svdss_tpu import cli as jax_cli
from svdss_tpu.config import Config as JConfig
from svdss_tpu.index.fmd import build_index as j_build_index
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu.pipeline import search as j_search
from svdss_tpu_torch import cli
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.index.fmd import build_index
from svdss_tpu_torch.io.fasta import write_fasta
from svdss_tpu_torch.ops.anchor_wide import (AnchorIndexWide,
                                             build_anchor_index_wide)
from svdss_tpu_torch.pipeline.search import run_search
from svdss_tpu_torch.pipeline.smooth import run_smooth
from svdss_tpu_torch.utils.seq import encode_nt6
from svdss_tpu_torch.utils.simulate import (make_haplotype, random_genome,
                                            simulate_reads, write_bam)

DEV = dict(use_device=True, lanes=16, max_sfs_per_read=128,
           engine="anchor")


def norm(groups):
    return [(q, [(s.qs, s.l, s.htag) for s in g]) for q, g in groups]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """The sample of tests/test_search_pipeline.py, with both packages'
    indexes and its forward text."""
    rng = np.random.default_rng(777)
    tmp = tmp_path_factory.mktemp("twide")
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
    return dict(smoothed=str(smoothed), index=build_index(chroms),
                jindex=j_build_index(chroms),
                fwd=encode_nt6(chroms["chrS"]))


# (tables, the port's driver): tables without the heavy store search in
# one-shot batches (heavy k-mers send the read to the host); with it, and
# a cmax low enough that many anchors are heavy, lanes park and the host
# answers their phases between waves
WIDE = {"one-shot": dict(k=9, cmax=32, keep_heavy=False),
        "parked-phase waves": dict(k=8, cmax=4)}


@pytest.mark.parametrize("driver", sorted(WIDE))
def test_run_search_wide_matches_jax_and_host(sample, driver, caplog):
    build = WIDE[driver]
    widx = build_anchor_index_wide(sample["fwd"].copy(), **build)
    jidx = j_build_anchor_index_wide(sample["fwd"].copy(), **build)
    if driver != "one-shot":
        assert widx.heavy_rate > 0.02
    caplog.set_level("INFO", logger="svdss_tpu")
    got = run_search(Config(**DEV), sample["index"], bam=sample["smoothed"],
                     device="cpu", anchor=widx)
    log = " ".join(r.getMessage() for r in caplog.records)
    assert "wide anchor engine on cpu" in log and driver in log
    assert "anchor pool on" not in log
    want = j_search.run_search(JConfig(**DEV), sample["jindex"],
                               bam=sample["smoothed"], anchor=jidx)
    host = run_search(Config(use_device=False), sample["index"],
                      bam=sample["smoothed"])
    assert norm(got) == norm(want) == norm(host)
    assert sum(len(g) for _, g in got) > 0


def test_cli_run_wide_matches_jax_host_run(tmp_path, monkeypatch, caplog):
    """With SVDSS_TPU_WIDE_ANCHOR=1, `run --device cpu` builds wide tables;
    at the default engine (FM on a genome this small) and at `--engine
    anchor` (the wide engine) its specifics.txt and VCF equal
    `svdss_tpu.cli run --no-device`'s byte for byte, on the
    tests/run-pipeline.sh sample."""
    rng = np.random.default_rng(12)
    chroms = random_genome(rng, {"chrZ": 80000})
    h1 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=2, n_del=2,
                        min_len=60, max_len=180)
    h2 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [h1, h2], coverage=12, read_len=2500)
    ref, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(ref, chroms)
    write_bam(bam, chroms, recs)
    monkeypatch.setenv("SVDSS_TPU_WIDE_ANCHOR", "1")
    auto_wd, anchor_wd, jax_wd = (tmp_path / d for d in
                                  ("auto", "anchor", "jax"))
    common = ["--reference", ref, "--bam", bam, "--device", "cpu",
              "--lanes", "16", "--threads", "2"]
    caplog.set_level("INFO", logger="svdss_tpu")
    assert cli.main(["run", "--workdir", str(auto_wd), *common]) == 0
    tables = auto_wd / "index.fmd.npz.anchor.npz"
    assert isinstance(AnchorIndexWide.load(str(tables)), AnchorIndexWide)
    assert "FM engine on cpu" in caplog.text
    caplog.clear()
    os.makedirs(anchor_wd)
    for f in ("index.fmd.npz", "index.fmd.npz.anchor.npz", "smoothed.bam"):
        os.link(auto_wd / f, anchor_wd / f)
    assert cli.main(["run", "--workdir", str(anchor_wd), "--engine",
                     "anchor", *common]) == 0
    assert "wide anchor engine on cpu" in caplog.text
    assert jax_cli.main(["run", "--reference", ref, "--bam", bam,
                         "--workdir", str(jax_wd), "--no-device",
                         "--threads", "2"]) == 0
    for name in ("specifics.txt", "variations.vcf"):
        want = (jax_wd / name).read_bytes()
        assert len(want) > 0
        assert (auto_wd / name).read_bytes() == want
        assert (anchor_wd / name).read_bytes() == want
