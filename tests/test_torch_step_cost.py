"""The port's step_cost (svdss_tpu_torch/tools/step_cost.py, the JAX
repo's tools/step_cost.py) on the CPU: the plain FM kernel's ``iters`` at
the JAX tool's budgets 960 and 1,920 and in full equals
pingpong_jax.batch_search's on the same reads (exact), and a ``--device
cpu`` run's JSON line holds those counts with every device time "not
measured"."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import FMDIndex as JFMDIndex
from svdss_tpu.ops import fmd_jax
from svdss_tpu.ops.pingpong_jax import batch_search as j_fm
from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
from svdss_tpu_torch.tools import bench as tbench
from svdss_tpu_torch.tools import step_cost

GENOME_BP, Q, L = 200_000, 8, 1000

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("step_cost"))
    index, genome = tbench.build_problem(GENOME_BP, Q, L, workdir=wd)
    reads, lens = tbench.make_reads(genome, Q, L)
    return wd, index, reads, lens


def test_iters_equal_jax(problem):
    wd, index, reads, lens = problem
    jindex = JFMDIndex.from_parts(index.n, index.C, index.occ,
                                  index.bwt_words)
    jdev = fmd_jax.DeviceFMDIndex.from_host(jindex)
    dev = DeviceFMDIndex.from_host(index, "cpu")
    seqs, lens_t = torch.from_numpy(reads), torch.from_numpy(lens)
    got = {b: step_cost.step_iters(dev, seqs, lens_t, b)
           for b in step_cost.BUDGETS}
    want = {b: int(j_fm(jdev, jnp.asarray(reads), jnp.asarray(lens),
                        cap=512, max_iters=b).iters)
            for b in step_cost.BUDGETS}
    assert got == want
    assert got[960] == 960 and got[1920] == 1920 and got[0] > 1920


def test_cpu_run_line(problem, capsys):
    wd, _, _, _ = problem
    rc = step_cost.main(["--device", "cpu", "--genome-bp", str(GENOME_BP),
                         "--reads", str(Q), "--read-len", str(L),
                         "--workdir", wd])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0 and line["device"] == {"device": "cpu"}
    assert (line["q"], line["L"]) == (Q, L)
    assert line["iters"]["960"] == 960 and line["iters"]["1920"] == 1920
    assert line["iters"]["full"] > 1920
    for k in ("ms", "marginal_us_per_step", "marginal_ns_per_lane",
              "avg_us_per_step", "reads_per_s"):
        assert line[k] == "not measured"
    assert sorted(line["cpu_ms"]) == ["1920", "960", "full"]
    assert all(v > 0 for v in line["cpu_ms"].values())
    assert out[0].startswith(f"Q={Q} L={L}: 960 iters in ")
    assert out[0].endswith("(cpu)") and "(cpu)" in out[-2]
    assert np.isfinite(line["cpu_avg_us_per_step"])
