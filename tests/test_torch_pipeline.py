"""The port's search and call stages and its `run` CLI, with the kernels'
plain versions on the CPU, against the JAX package on the samples of
tests/test_search_pipeline.py and tests/run-pipeline.sh. Outputs are
compared exactly."""

import io as _io
import os

import numpy as np
import pytest

from svdss_tpu import cli as jax_cli
from svdss_tpu.config import Config as JConfig
from svdss_tpu.index.fmd import build_index as j_build_index
from svdss_tpu.io.vcf import write_vcf as j_write_vcf
from svdss_tpu.pipeline.call import run_call as j_run_call
from svdss_tpu.pipeline.search import run_search as j_run_search
from svdss_tpu_torch import cli
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.index.fmd import build_index
from svdss_tpu_torch.io.fasta import write_fasta
from svdss_tpu_torch.io.vcf import write_vcf
from svdss_tpu_torch.pipeline.call import run_call
from svdss_tpu_torch.pipeline.search import run_search
from svdss_tpu_torch.pipeline.smooth import run_smooth
from svdss_tpu_torch.utils.simulate import (make_haplotype, random_genome,
                                            simulate_reads, write_bam)

DEV = dict(use_device=True, lanes=16, max_sfs_per_read=128)


def norm(groups):
    return [(q, [(s.qs, s.l, s.htag) for s in g]) for q, g in groups]


@pytest.fixture(scope="module")
def pipeline_data(tmp_path_factory):
    """The sample of tests/test_search_pipeline.py."""
    rng = np.random.default_rng(777)
    tmp = tmp_path_factory.mktemp("tpipe")
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
    return chroms, str(smoothed), build_index(chroms), j_build_index(chroms)


def test_run_search_matches_jax_device_and_host(pipeline_data):
    chroms, smoothed, index, jindex = pipeline_data
    got = run_search(Config(engine="fm", **DEV), index, bam=smoothed,
                     device="cpu")
    want = j_run_search(JConfig(engine="fm", **DEV), jindex, bam=smoothed)
    host = run_search(Config(use_device=False), index, bam=smoothed)
    assert norm(got) == norm(want) == norm(host)
    assert sum(len(g) for _, g in got) > 0


def test_run_call_matches_jax_device(pipeline_data):
    chroms, smoothed, index, jindex = pipeline_data
    groups = run_search(Config(use_device=False), index, bam=smoothed)
    sfs_map = {q: g for q, g in groups}
    svs, _, _ = run_call(Config(use_device=True), chroms, smoothed,
                         sfs_map, device="cpu")
    jsvs, _, _ = j_run_call(JConfig(use_device=True), chroms, smoothed,
                            sfs_map)
    got, want = _io.StringIO(), _io.StringIO()
    write_vcf(got, chroms, svs)
    j_write_vcf(want, chroms, jsvs)
    lines = [ln for ln in got.getvalue().splitlines()
             if not ln.startswith("#")]
    assert got.getvalue() == want.getvalue() and len(lines) >= 3


def test_cli_run_matches_jax_host_run(tmp_path):
    """`run --device cpu --engine fm` of the port == `svdss_tpu.cli run
    --no-device`, byte for byte, on the tests/run-pipeline.sh sample, and
    every planted SV is recovered."""
    rng = np.random.default_rng(12)
    chroms = random_genome(rng, {"chrZ": 80000})
    h1 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=2, n_del=2,
                        min_len=60, max_len=180)
    h2 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [h1, h2], coverage=12, read_len=2500)
    ref, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(ref, chroms)
    write_bam(bam, chroms, recs)
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    assert cli.main(["run", "--reference", ref, "--bam", bam, "--workdir",
                     str(out_t), "--device", "cpu", "--engine", "fm",
                     "--lanes", "16", "--threads", "2"]) == 0
    assert jax_cli.main(["run", "--reference", ref, "--bam", bam,
                         "--workdir", str(out_j), "--no-device",
                         "--threads", "2"]) == 0
    for name in ("specifics.txt", "variations.vcf"):
        assert (out_t / name).read_bytes() == (out_j / name).read_bytes()
    vcf = [ln for ln in (out_t / "variations.vcf").read_text().splitlines()
           if not ln.startswith("#")]
    for sv in h1.svs:
        assert any(f"SVTYPE={sv.type}" in ln
                   and abs(int(ln.split("\t")[1]) - sv.pos) < 200
                   for ln in vcf), (sv.type, sv.pos)
    assert os.path.getsize(out_t / "specifics.txt") > 0


def test_run_search_host_redo_matches(pipeline_data, tmp_path, caplog):
    """SFS-dense random reads overflow the emission cap (L // 16); those
    lanes are redone on the host, and the stage's output still equals the
    JAX device path and the host engines."""
    chroms, _, index, jindex = pipeline_data
    rng = np.random.default_rng(8)
    g = chroms["chrS"]
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as fh:
        for k in range(12):
            if k % 3 == 0:
                s = "".join("ACGT"[i] for i in rng.integers(0, 4, 900))
            else:
                p = int(rng.integers(0, len(g) - 900))
                s = g[p:p + 900]
            fh.write(f"@r{k}\n{s}\n+\n{'I' * len(s)}\n")
    caplog.set_level("INFO", logger="svdss_tpu")
    got = run_search(Config(engine="fm", **DEV), index, fastx=str(fq),
                     device="cpu")
    redo = [r.getMessage() for r in caplog.records
            if "host fallbacks" in r.getMessage()]
    assert redo and not redo[-1].endswith(" 0 host fallbacks")
    want = j_run_search(JConfig(engine="fm", **DEV), jindex, fastx=str(fq))
    host = run_search(Config(use_device=False), index, fastx=str(fq))
    assert norm(got) == norm(want) == norm(host)
