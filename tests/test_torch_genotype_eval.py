"""The port's genotype_eval (svdss_tpu_torch/tools/genotype_eval.py, the
JAX repo's tools/genotype_eval.py) on the CPU: at a 1 Mbp genome its
events, haplotypes, truth and reads equal the JAX tool's construction, and
its scoring gives the JAX tool's numbers and rows on the same VCF (the JAX
tool's pipeline call replaced by one that writes that VCF); a whole
``--no-device`` run calls and genotypes every planted SV and writes its
report under its work directory."""

import json
import os
import subprocess
import sys

from svdss_tpu_torch.io.fasta import write_fasta
from svdss_tpu_torch.tools import genotype_eval as G
from svdss_tpu_torch.utils.simulate import simulate_reads, write_bam

ARGS = dict(genome_mbp=1, n_hom=4, n_het=4, seed=97)
COVERAGE, READ_LEN = 1, 9000


def sv_fields(sv):
    return (sv.chrom, sv.type, sv.pos, sv.length, sv.seq)


def hap_fields(h):
    return (h.chrom, h.segments, [sv_fields(sv) for sv in h.svs])


def fake_vcf(truth) -> str:
    """Calls around the truth that reach every branch of the scoring:
    missed, exact, shifted within 200 bp, a nearer and a farther call of
    one type, the wrong type, too far, phased and unknown genotypes."""
    lines = ["##fileformat=VCFv4.2\n"]
    for i, (ty, pos) in enumerate(sorted(truth, key=lambda t: t[1])):
        other = "DEL" if ty == "INS" else "INS"
        rows = {0: [],
                1: [(ty, pos + 1, "1/1" if i % 2 else "./.")],
                2: [(ty, pos + 151, "0/1")],
                3: [(ty, pos + 121, "1/1"), (ty, pos + 1, "1|0")],
                4: [(other, pos + 1, "1/1"), (ty, pos + 251, "0/1")]}[i % 5]
        for t, p, gt in rows:
            lines.append(f"chrG\t{p}\t.\tN\t<{t}>\t.\tPASS\tSVTYPE={t}\t"
                         f"GT:GQ\t{gt}:30\n")
    return "".join(lines)


def test_truth_reads_and_scores_equal_the_jax_tools(tmp_path, monkeypatch,
                                                    capsys):
    import svdss_tpu.utils.simulate as jsim
    import tools.genotype_eval as jge
    rng, chroms, events, h1, h2, truth = G.make_truth(**ARGS)
    vcf = fake_vcf(truth)
    seen = {}
    real_sim = jsim.simulate_reads

    def sim(rng_, haps, **kw):
        seen["haps"] = haps
        return real_sim(rng_, haps, **kw)

    def run(cmd, **kw):
        out = cmd[cmd.index("--workdir") + 1]
        os.makedirs(out)
        with open(os.path.join(out, "variations.vcf"), "w") as fh:
            fh.write(vcf)
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, "", "")

    jwd = tmp_path / "jax"
    os.makedirs(jwd)
    monkeypatch.setattr(jsim, "simulate_reads", sim)
    monkeypatch.setattr(jge.subprocess, "run", run)
    monkeypatch.setattr(jge.tempfile, "mkdtemp", lambda prefix: str(jwd))
    monkeypatch.setattr(sys, "argv", [
        "genotype_eval.py", "--genome-mbp", "1", "--coverage", str(COVERAGE),
        "--n-hom", "4", "--n-het", "4", "--out", ""])
    assert jge.main() == 0
    monkeypatch.undo()
    out = capsys.readouterr().out.strip().splitlines()
    assert seen["cmd"][seen["cmd"].index("run") - 2:][:3] == [
        "-m", "svdss_tpu.cli", "run"]

    # the sample: the same haplotypes, truth and reads
    assert [hap_fields(h) for h in seen["haps"]] == [hap_fields(h1),
                                                     hap_fields(h2)]
    kinds = [k for _, k in events]
    assert out[0].endswith(f"({kinds.count('hom')} hom + "
                           f"{kinds.count('het')} het SVs)")
    recs = simulate_reads(rng, [h1, h2], coverage=COVERAGE,
                          read_len=READ_LEN)
    write_fasta(str(tmp_path / "ref.fa"), chroms)
    write_bam(str(tmp_path / "reads.bam"), chroms, recs)
    for f in ("ref.fa", "reads.bam"):
        assert (tmp_path / f).read_bytes() == (jwd / f).read_bytes()

    # the scoring: the JAX tool's numbers and rows on the same VCF
    path = tmp_path / "calls.vcf"
    path.write_text(vcf)
    got, rows = G.score(truth, G.read_calls(str(path)))
    want = json.loads(out[-1])
    assert want.pop("deviation_note") == G.DEVIATION
    assert got == want
    assert [f"[gt] {r[0]} @{r[1]} truth={r[2]} called={r[3]}"
            for r in rows] == [ln for ln in out if " truth=" in ln]
    assert 0 < got["n_called"] < got["n_truth"] == len(truth)
    assert 0 < got["gt_concordance"] < 1


def test_host_run_calls_every_sv(tmp_path, capsys):
    wd = tmp_path / "wd"
    rc = G.main(["--genome-mbp", "1", "--coverage", "10", "--n-hom", "4",
                 "--n-het", "4", "--no-device", "--device", "cpu",
                 "--workdir", str(wd)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["path"] == "host"
    assert line["n_called"] == line["n_truth"] == 8
    assert line["gt_concordance"] == 1.0
    assert line["device"] == {"device": "cpu"} and line["pipeline_s"] > 0
    assert json.loads((wd / "genotype.json").read_text()) == line
    assert sorted(os.listdir(wd)) == ["genotype.json", "out", "reads.bam",
                                      "ref.fa"]
