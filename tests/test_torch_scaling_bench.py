"""The port's scaling_bench (svdss_tpu_torch/tools/scaling_bench.py, the
JAX repo's tools/scaling_bench.py) on the CPU: its workload equals the JAX
tool's file for file (reference, BAM bytes, index arrays); real 1- and
2-process runs of ``python -m svdss_tpu_torch.cli search --device cpu``
(the plain FM kernel) merge to the same SFSs, which equal ``svdss_tpu.cli
search --no-device`` on the same inputs after the tool's canon; and the
report's efficiency rule and its exit code on a mismatch."""

import json
import os

import numpy as np
import pytest

from svdss_tpu import cli as jcli
from svdss_tpu_torch.tools import scaling_bench as S

READS, READ_LEN = 40, 1000


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    import tools.scaling_bench as jsb
    jwd = tmp_path_factory.mktemp("jax")
    wd = tmp_path_factory.mktemp("port")
    return (jsb.make_workload(str(jwd), READS, READ_LEN),
            S.make_workload(str(wd), READS, READ_LEN), str(wd))


def test_workload_equals_the_jax_tools(work):
    want, got, _ = work
    assert got["n_reads"] == want["n_reads"] > 0
    for f in ("ref", "bam"):
        assert open(got[f], "rb").read() == open(want[f], "rb").read()
    with np.load(got["idx"]) as a, np.load(want["idx"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_processes_merge_to_the_jax_host_sfs(work, tmp_path):
    _, w, wd = work
    ref = str(tmp_path / "jax_sfs.txt")
    assert jcli.main(["search", "--index", w["idx"], "--bam", w["bam"],
                      "--out", ref, "--no-device"]) == 0
    want = S.canon(ref)
    assert len(want) > w["n_reads"]
    for p in (1, 2):
        wall, stage, out = S.run_procs(w, wd, p, ["--device", "cpu",
                                                  "--lanes", "64"], 1)
        assert 0 < stage <= wall
        assert S.canon(out) == want, p
    assert os.path.exists(os.path.join(wd, "sfs_p2.txt.1"))


def test_report_and_exit_code(work, tmp_path, monkeypatch, capsys):
    """main() over stand-in runs: efficiency stage(1) / (P x stage(P)),
    reads/s from the stage, exit 1 when the merged outputs differ."""
    _, w, _ = work
    stages = {1: 2.0, 2: 1.25}

    def fake(work_, wd, p, path_args, threads):
        assert path_args == (["--no-device"] if host else
                             ["--device", "cpu", "--lanes", "64"])
        out = os.path.join(wd, f"sfs_p{p}.txt")
        with open(out, "w") as fh:
            fh.write(f"r1\t5\t7\t0\n*\t9\t{7 if p == 1 or same else 8}\t0\n")
        return 3.0, stages[p], out

    monkeypatch.setattr(S, "run_procs", fake)
    argv = ["--reads", str(READS), "--read-len", str(READ_LEN), "--device",
            "cpu", "--workdir", str(tmp_path)]
    host = False
    for same, rc in ((True, 0), (False, 1)):
        assert S.main(argv) == rc
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["merged_outputs_identical"] is same
        assert line["n_reads"] == w["n_reads"] and line["path"] == "device"
        assert line["efficiency"] == "not measured"
        assert line["cpu_efficiency"] == {"1": 1.0, "2": 0.8}
        assert line["cpu_reads_per_s"] == {
            "1": w["n_reads"] / 2.0, "2": w["n_reads"] / 1.25}
        assert line["device"] == {"device": "cpu"}
    # the host engines' stage times are host numbers, under their names
    host = same = True
    assert S.main(argv + ["--no-device"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["path"] == "host"
    assert line["efficiency"] == {"1": 1.0, "2": 0.8}
    assert line["stage_s"] == {"1": 2.0, "2": 1.25}
