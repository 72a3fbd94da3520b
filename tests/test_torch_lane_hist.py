"""The port's lane_hist and len_sweep (svdss_tpu_torch/tools/, the JAX
repo's tools/lane_hist.py and tools/len_sweep.py) against the JAX tools
and anchor_jax on the CPU at a 200 kb genome: K3's per-lane stop rounds
(debug_hist) equal anchor_jax.batch_search_anchor's on the same reads, the
JAX tools' printed quantiles, utilization and decay lines equal the
port's, and len_sweep's lane rule, rounds, quantiles, fallbacks and SFS
counts equal the JAX tool's at each length. Exact (every value an integer
or a statistic of integers; the JAX tools round theirs as printed)."""

import importlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from svdss_tpu.ops.anchor import AnchorIndex as JAnchorIndex
from svdss_tpu.ops.anchor_jax import (batch_search_anchor as j_anchor,
                                      build_device_anchor as j_device_anchor)
from svdss_tpu_torch.ops.anchor_device import build_device_anchor
from svdss_tpu_torch.tools import bench as tbench
from svdss_tpu_torch.tools import lane_hist, len_sweep

GENOME_BP = 200_000
READS, READ_LEN = 32, 2000
SWEEP = ["--genome-bp", str(GENOME_BP), "--lens", "1000,2500",
         "--base-reads", "64", "--iters", "1"]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tools(tmp_path_factory):
    """The JAX tools' modules with their caches (bench.py's index, the
    anchor tables) kept in a temporary directory instead of the repo, and
    without JAX's persistent compile cache (init_device_runtime points it
    under the home directory)."""
    import svdss_tpu.utils.device as jdevice
    tmp = tmp_path_factory.mktemp("jax_tools")
    os.makedirs(tmp / "tools")
    mods = {n: importlib.import_module(f"tools.{n}")
            for n in ("lane_hist", "len_sweep")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdevice, "init_device_runtime", lambda: None)
        mp.setattr(bench, "__file__", str(tmp / "bench.py"))
        for n, m in mods.items():
            mp.setattr(m, "__file__", str(tmp / "tools" / f"{n}.py"))
        yield tmp, mods


def run_jax(mod, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    assert mod.main() == 0
    return capsys.readouterr().out.strip().splitlines()


def test_lane_hist_equals_jax(jax_tools, tmp_path, capsys, monkeypatch):
    tmp, mods = jax_tools
    argv = ["--genome-bp", str(GENOME_BP), "--reads", str(READS),
            "--read-len", str(READ_LEN)]
    want = run_jax(mods["lane_hist"], argv, capsys, monkeypatch)
    want = [ln for ln in want if ln.startswith(("[lane-hist]", "  "))]
    assert lane_hist.main(argv + ["--device", "cpu", "--workdir",
                                  str(tmp_path)]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 9 and want[0].startswith("[lane-hist] run ")
    assert got[0].startswith("[lane-hist] run ") and "(cpu)" in got[0]
    assert got[0].split(", ")[-1] == want[0].split(", ")[-1]   # iters=
    assert got[1:9] == want[1:9]
    line = json.loads(got[-1])
    assert line["run_s"] == "not measured" and line["cpu_run_s"] > 0
    assert line["device"] == {"device": "cpu"}
    assert line["round_cap"] == tbench.round_cap(READ_LEN)

    # the stop rounds themselves, against anchor_jax on the same reads
    genome = tbench.make_genome(GENOME_BP)
    reads, lens = tbench.make_reads(genome, READS, READ_LEN)
    jaidx = JAnchorIndex.load(str(tmp / f".bench_anchor_{GENOME_BP}_16.npz"))
    jdidx, jparams = j_device_anchor(jaidx)
    jres, jdone = j_anchor(jdidx, jparams, jnp.asarray(reads),
                           jnp.asarray(lens), cap=512, debug_hist=True)
    didx, params = build_device_anchor(
        tbench.build_anchor(genome, GENOME_BP, workdir=str(tmp_path)), "cpu")
    res, done, _ = lane_hist.run_hist(didx, params, reads, lens, 512,
                                      torch.device("cpu"))
    assert np.array_equal(done, np.asarray(jdone))
    assert int(res.iters) == int(jres.iters) == line["iters"]
    assert np.array_equal(res.n_sfs.numpy(), np.asarray(jres.n_sfs))
    h = lane_hist.hist(done, int(res.iters))
    assert {k: line[k] for k in h} == h
    d2 = lane_hist.finish_rounds(np.asarray(jdone), int(jres.iters))
    assert h["utilization"] == d2.mean() / int(jres.iters)


def test_len_sweep_equals_jax(jax_tools, tmp_path, capsys, monkeypatch):
    tmp, mods = jax_tools
    want = json.loads(run_jax(mods["len_sweep"], SWEEP, capsys,
                              monkeypatch)[-1])
    assert len_sweep.main(SWEEP + ["--device", "cpu", "--workdir",
                                   str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["device"] == {"device": "cpu"}
    assert sorted(k for k in got if k != "device") == sorted(want) == \
        ["1000", "2500"]
    for L, w in want.items():
        g = got[L]
        assert g["Q"] == w["Q"] == len_sweep.lanes_for(64, int(L))
        for k in ("total_rounds", "done_p50", "done_p90", "done_p99",
                  "done_max", "fallback", "sfs"):
            assert g[k] == w[k], (L, k)
        assert round(g["done_mean"], 1) == w["done_mean"]
        assert round(g["util"], 3) == w["util"]
        for k in ("reads_per_s", "t", "warm_s", "ns_per_lane_round"):
            assert g[k] == "not measured" and g["cpu_" + k] > 0
    assert [len_sweep.lanes_for(4096, L) for L in (2000, 10000, 30000)] == \
        [20480, 4096, 1280]
