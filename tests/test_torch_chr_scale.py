"""svdss_tpu_torch/tools/chr_scale.py against the JAX repo's
tools/chr_scale.py, on the CPU at a tiny size (2 Mbp over 2 chromosomes):

- its --sim-only sample equals the JAX tool's: ref.fa and truth.txt byte
  for byte, the decompressed reads.bam streams, the read count (with the
  records written in one slice a chromosome and in many);
- with --no-device both tools score the same calls and write the same VCF;
- with --device cpu --engine anchor --check-host (the kernels' plain
  versions, then the host engines on hard links) every planted SV is
  recovered and the two runs' outputs are identical;
- score() keeps the 200 bp rule: SVTYPE, chromosome, |pos - call| < 200;
- parse_line reads the lines the stages print;
- without a card, and without --device cpu, the tool raises.

Integer results and files: equality is exact."""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from svdss_tpu_torch.tools import chr_scale

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--genome-mbp", "2", "--n-chrom", "2", "--coverage", "10",
        "--read-len", "3000", "--n-sv", "8"]


def quiet(_msg):
    pass


def jax_tool(argv, workdir):
    """The JAX repo's tool, as tests/chr_scale.sh runs it; its JSON line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "chr_scale.py"), *argv,
         "--workdir", str(workdir)], capture_output=True, text=True,
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.stdout, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def bam_stream(path) -> bytes:
    with gzip.open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_sim(tmp_path_factory):
    wd = tmp_path_factory.mktemp("jax_sim")
    return jax_tool([*TINY, "--sim-only"], wd), wd


@pytest.mark.parametrize("slice_records", [chr_scale.SLICE_RECORDS, 500])
def test_sim_only_equals_the_jax_tool(jax_sim, tmp_path, monkeypatch,
                                      slice_records):
    monkeypatch.setattr(chr_scale, "SLICE_RECORDS", slice_records)
    want, jwd = jax_sim
    rep = chr_scale.main([*TINY, "--sim-only", "--workdir", str(tmp_path)],
                         log=quiet)
    assert rep["ok"] and rep["n_reads"] == want["n_reads"] > 3 * 500
    for f in ("ref.fa", "truth.txt"):
        assert (tmp_path / f).read_bytes() == (jwd / f).read_bytes()
    assert bam_stream(tmp_path / "reads.bam") == \
        bam_stream(jwd / "reads.bam")
    truth = (tmp_path / "truth.txt").read_text().splitlines()
    assert {ln.split("\t")[3] for ln in truth} == {"chr1", "chr2"}


def test_no_device_run_equals_the_jax_tool(tmp_path):
    argv = [*TINY, "--no-device", "--keep"]
    want = jax_tool(argv, tmp_path / "jax")
    rep = chr_scale.main([*argv, "--workdir", str(tmp_path / "port")],
                         log=quiet)
    assert rep["ok"] and want["ok"]
    for k in ("planted", "recovered", "calls", "recall", "precision", "f1",
              "n_reads"):
        assert rep[k] == want[k], k
    vcf = "out/variations.vcf"
    assert (tmp_path / "port" / vcf).read_bytes() == \
        (tmp_path / "jax" / vcf).read_bytes()
    assert rep["engine"] == "host" and rep["device"] is False
    assert set(want["stage_s"]) <= set(rep["stage_s"])


def test_plain_versions_with_the_host_check(tmp_path):
    out = tmp_path / "report.json"
    rep = chr_scale.main([*TINY, "--device", "cpu", "--engine", "anchor",
                          "--check-host", "--workdir", str(tmp_path / "wd"),
                          "--out", str(out)], log=quiet)
    assert rep["ok"] and rep["host_identical"] is True
    assert rep["recovered"] == rep["planted"] == 8 and rep["f1"] == 1.0
    assert set(rep["stage_s"]) == {"index", "anchor_build", "smooth",
                                   "search", "call"}
    assert set(rep["host_stage_s"]) == {"search", "call"}
    assert rep["engine"] == "anchor, pool" and rep["wide_tables"] is False
    assert rep["wide_by_size"] is False
    assert rep["index_symbols"] == 2 * (2_000_000 + 2)
    assert rep["fallbacks"] == 0 and rep["card"] == {"device": "cpu"}
    assert rep["peak_rss_gib"] > 0 and rep["disk_gib"] > 0
    assert json.loads(out.read_text())["host_identical"] is True
    # the run's log is kept beside its outputs
    assert "search:" in (tmp_path / "wd" / "out.log").read_text()


VCF = "chr1\t{pos}\t.\tN\t<{ty}>\t.\tPASS\tVARTYPE=SV;SVTYPE={ty};SVLEN=90\n"


@pytest.mark.parametrize("call,hit", [
    (("chr1", 1000, "DEL"), True),
    (("chr1", 1199, "DEL"), True),          # 199 bp away
    (("chr1", 801, "DEL"), True),
    (("chr1", 1200, "DEL"), False),         # exactly 200 bp
    (("chr1", 800, "DEL"), False),
    (("chr1", 1000, "INS"), False),         # another type
    (("chr2", 1000, "DEL"), False),         # another chromosome
])
def test_score_200bp_rule(call, hit):
    chrom, pos, ty = call
    line = VCF.format(pos=pos, ty=ty).replace("chr1", chrom, 1)
    got = chr_scale.score([["DEL", "1000", "90", "chr1"]], [line])
    assert got["recovered"] == got["planted"] * hit == int(hit)
    assert got["precision"] == float(hit) and got["calls"] == 1
    assert got["f1"] == float(hit)
    # a truth row without a chromosome matches on any
    if chrom == "chr2":
        assert chr_scale.score([["DEL", "1000", "90"]],
                               [line])["recovered"] == 1


def test_score_counts_each_side():
    truth = [["DEL", "1000", "90", "chr1"], ["INS", "5000", "120", "chr1"],
             ["DEL", "9000", "60", "chr2"]]
    vcf = [VCF.format(pos=1050, ty="DEL"), VCF.format(pos=1100, ty="DEL"),
           VCF.format(pos=7000, ty="INS")]
    got = chr_scale.score(truth, vcf)
    assert got == {"planted": 3, "recovered": 1, "calls": 3,
                   "recall": 0.3333, "precision": 0.6667, "f1": 0.4444}


# the lines of a `run` on the wide path (800 Mbp over 8 chromosomes: wide
# tables by size), as the stages print them
LOG = """\
[16:53:57] [INFO] run: index built in 438.0s (1600000016 symbols)
[16:57:36] [INFO] index: WIDE anchor tables (k=14, 800000007 fwd symbols) \
built in 218.9s, peak RSS 28.24 GiB -> /w/out/index.fmd.npz.anchor.npz
[16:58:34] [INFO] smooth: max allowed mismatch ratio 0.00285
[17:00:15] [INFO] smooth: 1999914 alignments in 102.79s (19456.0 aln/s, \
native); XF0=8288 XF1=39588 XF2=1952012 XF3=26 dropped=0
[17:01:47] [INFO] search: wide anchor engine on cuda (k=14, tables 6.62 \
GiB, parked-phase waves; host peak RSS 80.72 GiB)
[17:02:09] [INFO] search: 8288 reads in 22.50s (368.4 reads/s), 12 host \
fallbacks
[17:03:34] [INFO] call: 576 clusters
[17:03:57] [INFO] call: 576 SVs in 107.62s
"""


def parse_log(lines):
    out = {}
    for line in lines:
        chr_scale.parse_line(out, line)
    return out


def test_parse_line_reads_the_stage_lines():
    got = parse_log(LOG.splitlines())
    assert got["stage_s"] == {"index": 438.0, "anchor_build": 218.9,
                              "smooth": 102.79, "search": 22.5,
                              "call": 107.62}
    assert got["index_symbols"] == 1_600_000_016 and got["wide_tables"]
    assert got["anchor_build_peak_rss_gib"] == 28.24
    assert got["smooth_xf"] == {"XF0": 8288, "XF1": 39588, "XF2": 1952012,
                                "XF3": 26, "dropped": 0}
    assert got["engine"] == "wide anchor, parked-phase waves"
    assert got["tables_gib"] == 6.62 and got["fallbacks"] == 12
    assert got["search_reads"] == 8288 and got["svs"] == 576
    fm = parse_log([
        "[x] [WARNING] search: engine cost model picks FM — anchor ~40 "
        "gathers/phase (pw bucket depth 9, heavy rate 0.1%) vs FM ~36; "
        "--engine anchor to override",
        "[x] [INFO] search: FM engine on cuda (fused table 950.0 MiB)",
        "[x] [INFO] search: 10 reads in 1.00s (10.0 reads/s), 0 host "
        "fallbacks"])
    assert fm["engine"] == "fm" and fm["cost_model_picks_fm"]
    host = parse_log(["[x] [INFO] search: 10 reads in 0.50s "
                                "(20.0 reads/s)"])
    assert host["fallbacks"] == 0 and host["stage_s"] == {"search": 0.5}
    pool = parse_log([
        "[x] [INFO] search: anchor engine on cuda (k=14, tables 4.16 GiB; "
        "host peak RSS 20.00 GiB)",
        "[x] [INFO] search: anchor pool on cuda — 4096 lanes, chunks of "
        "8192 reads, width 16384"])
    assert pool["engine"] == "anchor, pool" and pool["tables_gib"] == 4.16


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_raises_without_a_card(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chr_scale.main([*TINY, "--workdir", str(tmp_path)], log=quiet)
    # nothing was simulated before the refusal
    assert not os.path.exists(tmp_path / "reads.bam")
