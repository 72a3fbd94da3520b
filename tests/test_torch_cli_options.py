"""The CLI options no other port test passes, held against ``svdss_tpu.cli``
with the same option on the same sample, on the CPU: the port's ``search``
and ``call`` with ``--device cpu`` (the kernels' plain versions; ``search``
through the FM engine and through ``--engine anchor``), the JAX package's
with ``--no-device`` (its exact host engines). specifics.txt, the VCF and
the ``--poa`` SAM must be equal byte for byte.

Each option also changes the output against the same stage without it,
except where it cannot:

- ``--omax`` only sets how many SFSs the search holds before it writes them
  (the reference's deferred output), so the file is the same;
- ``--gt``: both CLIs regenotype the calls after ``call`` has written the
  VCF (``svdss_tpu/cli.py:209-210``), so the VCF is the same; the test holds
  that equality too.

The sample: tests/run-pipeline.sh's 80 kb genome (2 INS and 2 DEL on one
haplotype, 12x of 2.5 kb reads) with 0.5% small indels, so lengths within
a cluster differ (``-l``), and six reads clipped on each side of a
breakpoint with no SV, whose clipped parts carry SFSs (``--clipped``)."""

import os

import numpy as np
import pytest
import torch

from svdss_tpu import cli as jax_cli
from svdss_tpu_torch import cli
from svdss_tpu_torch.io.bam import BAM_CMATCH, BAM_CSOFT_CLIP, BamRecord
from svdss_tpu_torch.io.fasta import write_fasta
from svdss_tpu_torch.utils.simulate import (BASES, make_haplotype,
                                            random_genome, simulate_reads,
                                            write_bam)

torch.set_num_threads(1)

CLIP_AT = 70_000      # no planted SV within 20 kb


def clipped_reads(rng, ref: str, at: int, n: int = 6) -> list:
    """n reads soft-clipped on the left at `at` and n soft-clipped on the
    right ending at `at + 50`, their clipped parts from one novel 900 bp
    sequence."""
    novel = BASES[rng.integers(0, 4, 900)].tobytes().decode()
    out = []
    for i in range(n):
        out.append(BamRecord(
            qname=f"lclip{i}", flag=0, tid=0, pos=at, mapq=60,
            cigar=[(600, BAM_CSOFT_CLIP), (1500, BAM_CMATCH)],
            seq=novel[300:] + ref[at:at + 1500], qual=b"\x28" * 2100,
            aux=[("HP", "i", 1)]))
        out.append(BamRecord(
            qname=f"rclip{i}", flag=0, tid=0, pos=at + 50 - 1500, mapq=60,
            cigar=[(1500, BAM_CMATCH), (600, BAM_CSOFT_CLIP)],
            seq=ref[at + 50 - 1500:at + 50] + novel[:600],
            qual=b"\x28" * 2100, aux=[("HP", "i", 1)]))
    return out


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """ref.fa, the port's index and smoothed BAM, and the baseline outputs
    of `search` (FM) and `call` without any of the options."""
    tmp = tmp_path_factory.mktemp("cliopts")
    rng = np.random.default_rng(12)
    chroms = random_genome(rng, {"chrZ": 80000})
    h1 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=2, n_del=2,
                        min_len=60, max_len=180)
    h2 = make_haplotype(rng, "chrZ", chroms["chrZ"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [h1, h2], coverage=12, read_len=2500,
                          indel_rate=0.005)
    recs += clipped_reads(rng, chroms["chrZ"], CLIP_AT)
    recs.sort(key=lambda r: (r.tid, r.pos))
    d = {k: str(tmp / f) for k, f in (
        ("ref", "ref.fa"), ("bam", "reads.bam"), ("sm", "smoothed.bam"),
        ("idx", "index.fmd.npz"), ("sfs", "specifics.txt"),
        ("vcf", "calls.vcf"), ("dir", ""))}
    write_fasta(d["ref"], chroms)
    write_bam(d["bam"], chroms, recs)
    assert cli.main(["index", "--reference", d["ref"], "--index",
                     d["idx"]]) == 0
    assert cli.main(["smooth", "--reference", d["ref"], "--bam", d["bam"],
                     "--out", d["sm"], "--threads", "1"]) == 0
    assert port_search(d, d["sfs"], "fm", []) == 0
    assert port_call(d, d["vcf"], []) == 0
    return d


def port_search(d, out, engine, opts):
    return cli.main(["search", "--index", d["idx"], "--bam", d["sm"],
                     "--out", out, "--device", "cpu", "--engine", engine,
                     "--lanes", "16", "--threads", "1", *opts])


def port_call(d, out, opts):
    return cli.main(["call", "--reference", d["ref"], "--bam", d["sm"],
                     "--sfs", d["sfs"], "--out", out, "--device", "cpu",
                     "--threads", "1", *opts])


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


SEARCH_CASES = [("noputative", ["--noputative"], True),
                ("noassemble", ["--noassemble"], True),
                ("omax", ["--omax", "5"], False)]


@pytest.mark.parametrize("name,opts,changes", SEARCH_CASES,
                         ids=[c[0] for c in SEARCH_CASES])
def test_search_option_matches_jax(sample, name, opts, changes):
    d = sample
    want_path = os.path.join(d["dir"], f"jax_{name}.txt")
    assert jax_cli.main(["search", "--index", d["idx"], "--bam", d["sm"],
                         "--out", want_path, "--no-device", "--threads", "1",
                         *opts]) == 0
    want = read(want_path)
    assert len(want) > 0
    for engine in ("fm", "anchor"):
        got_path = os.path.join(d["dir"], f"port_{name}_{engine}.txt")
        assert port_search(d, got_path, engine, opts) == 0
        assert read(got_path) == want, engine
    assert (want != read(d["sfs"])) == changes


CALL_CASES = [("clipped", ["--clipped"], True),
              ("noht", ["--noht"], True),
              ("gt", ["--gt"], False),
              ("poa", ["--poa"], False),
              ("l", ["-l", "0.8"], True)]


@pytest.mark.parametrize("name,opts,changes", CALL_CASES,
                         ids=[c[0] for c in CALL_CASES])
def test_call_option_matches_jax(sample, name, opts, changes):
    """`--poa` writes its SAM beside an unchanged VCF; the SAM holds a
    consensus a cluster."""
    d = sample
    files = {}
    for who in ("port", "jax"):
        vcf = os.path.join(d["dir"], f"{who}_{name}.vcf")
        extra = list(opts)
        if name == "poa":
            files[who] = os.path.join(d["dir"], f"{who}_{name}.sam")
            extra.append(files[who])
        if who == "port":
            assert port_call(d, vcf, extra) == 0
        else:
            assert jax_cli.main(["call", "--reference", d["ref"], "--bam",
                                 d["sm"], "--sfs", d["sfs"], "--out", vcf,
                                 "--no-device", "--threads", "1",
                                 *extra]) == 0
    got = read(os.path.join(d["dir"], f"port_{name}.vcf"))
    assert got == read(os.path.join(d["dir"], f"jax_{name}.vcf"))
    assert (got != read(d["vcf"])) == changes
    if name == "clipped":
        flag = b";IMPRECISE\t"
        assert flag in got and flag not in read(d["vcf"])
    if name == "poa":
        sam = read(files["port"])
        assert sam == read(files["jax"])
        assert sam.startswith(b"@HD") and len(sam.splitlines()) > 2
