"""The port's profiler (svdss_tpu_torch/tools/profile.py, the counterpart
of the JAX repo's tools/profile_search.py and profile_anchor.py) on the
CPU: its trace arithmetic on synthetic Chrome-trace events (the union of
device intervals, busy share, idle gaps and the innermost host event open
in each, the launching op by correlation id, the listing's top and floor),
the mapping of every ``__global__`` kernel of csrc/ to K1-K6, the labels it
puts around the package's functions and takes off again, and ``--device
cpu`` runs that label everything cpu and write "not measured" for each
device number. The isolation test's walk covers this slice's seven tools.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from svdss_tpu_torch import cli
from svdss_tpu_torch.tools import profile as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOOLS = ("profile", "gather_model", "lane_hist", "len_sweep",
             "step_cost", "scaling_bench", "genotype_eval")

torch.set_num_threads(1)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_interval_arithmetic():
    merged = P.union([(5, 7), (0, 2), (1, 3), (10, 12), (7, 8)])
    assert merged == [(0, 3), (5, 8), (10, 12)]
    assert P.busy(merged, 0, 20) == 3 + 3 + 2
    assert P.busy(merged, 1, 11) == 2 + 3 + 1
    assert P.idle_gaps(merged, 0, 20) == [(12, 20), (3, 5), (8, 10)]
    assert P.idle_gaps(merged, 1, 6) == [(3, 5)]
    assert P.idle_gaps([], 4, 9) == [(4, 9)]
    host = P.Intervals([ev("user_annotation", "outer", 0, 100),
                        ev("cpu_op", "aten::copy_", 10, 5),
                        ev("cuda_runtime", "cudaMemcpyAsync", 11, 2)])
    assert host.innermost(12)["name"] == "cudaMemcpyAsync"
    assert host.innermost(14)["name"] == "aten::copy_"
    assert host.innermost(15)["name"] == "outer"     # ends are open
    assert P.host_name(host.innermost(150)) == "python"


def test_analyse_synthetic_trace():
    """A 100 µs window: K3 at [10, 40), a copy at [35, 50) and K2 at
    [70, 80); busy 50 µs; the gaps [50, 70), [80, 100), [0, 10) (longest
    first, ties in order) with the innermost host event open at their
    middles; each device event's launching op by correlation id."""
    events = [
        ev("user_annotation", "profile:anchor", 0, 100),
        ev("user_annotation", "K3 batch_search_anchor", 1, 8),
        ev("cuda_driver", "cuLaunchKernel", 2, 1, correlation=1),
        ev("overhead", "Activity Buffer Request", 3, 4),
        ev("cpu_op", "aten::copy_", 30, 6),
        ev("cuda_runtime", "cudaMemcpyAsync", 31, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=3),
        ev("cpu_op", "aten::sum", 85, 10),
        ev("kernel", "void anchor_batch_kernel<0>(Tables, ...)", 10, 30,
           correlation=1),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 35, 15,
           correlation=2),
        ev("kernel", "void pingpong_fm_kernel<int, false>(...)", 70, 10,
           correlation=3),
        ev("kernel", "outside the window", 150, 10, correlation=9),
        ev("gpu_user_annotation", "profile:anchor", 10, 70),
        {"ph": "i", "cat": "cpu_instant_event", "name": "x", "ts": 5},
    ]
    rep = P.analyse(events, "profile:anchor")
    assert rep["window_ms"] == pytest.approx(0.1)
    assert rep["device_busy_ms"] == pytest.approx(0.05)
    assert rep["busy_share"] == pytest.approx(0.5)
    assert rep["device_events"] == 3
    assert rep["kernels_in_trace"] == {"K3": 1, "K2": 1}
    by_kernel = {r["name"]: r for r in rep["by_kernel"]}
    k3 = by_kernel["void anchor_batch_kernel<0>(Tables, ...)"]
    assert k3["kernel"] == "K3" and k3["count"] == 1
    assert k3["share"] == pytest.approx(30 / 55)
    assert by_kernel["Memcpy DtoH (Device -> Pinned)"]["kernel"] is None
    assert {r["name"]: r["ms"] for r in rep["by_op"]} == pytest.approx(
        {"K3 batch_search_anchor": 0.03, "aten::copy_": 0.015,
         "profile:anchor": 0.01})
    gaps = [(g["at_ms"], g["ms"], g["host"], g["host_cat"])
            for g in rep["idle_gaps"]]
    assert gaps == pytest.approx([(0.05, 0.02, "cudaLaunchKernel",
                                   "cuda_runtime"),
                                  (0.08, 0.02, "aten::sum", "cpu_op"),
                                  (0.0, 0.01, "Activity Buffer Request",
                                   "overhead")])
    assert rep["profiler_overhead_ms"] == pytest.approx(0.004)
    with pytest.raises(RuntimeError, match="no 'profile:fm'"):
        P.analyse(events, "profile:fm")


def test_listing_top_and_floor(monkeypatch):
    dev = [ev("kernel", f"k{i}", i * 10, 1000 - 10 * i) for i in range(40)]
    dev.append(ev("gpu_memset", "Memset (Device)", 0, 1))
    rows = P.listing(dev, lambda e: e["name"])
    total = sum(e["dur"] for e in dev)
    assert [r["name"] for r in rows] == [f"k{i}" for i in range(40)]
    assert sum(r["share"] for r in rows) == pytest.approx(1 - 1 / total)
    monkeypatch.setattr(P, "TOP", 5)
    assert len(P.listing(dev, lambda e: e["name"])) == 5
    monkeypatch.setattr(P, "FLOOR", 0.03)
    # 970 / 32,201 is above 3%, 960 / 32,201 below
    assert [r["name"] for r in P.listing(dev, lambda e: e["name"])] == \
        ["k0", "k1", "k2", "k3"]
    assert P.launching_op(dev[0], {}, P.Intervals([])) == \
        "(launch not in trace)"


def test_every_kernel_of_csrc_is_named():
    """Each __global__ kernel in svdss_tpu_torch/csrc/ maps to one of
    K1-K6, and each of K1-K6 has a kernel."""
    found = {}
    csrc = os.path.join(ROOT, "svdss_tpu_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        src = open(os.path.join(csrc, f)).read()
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                               r"\([^)]*\)\s+)?(\w+)", src):
            found[name] = P.kernel_label(f"void {name}<0>(int*, int)")
    assert len(found) == 7 and None not in found.values()
    assert set(found.values()) == {f"K{i}" for i in range(1, 7)}
    assert set(found) == set(P.GLOBALS)
    assert P.kernel_label("Memcpy HtoD (Pageable -> Device)") is None


def test_program_spans_show_in_a_cpu_profile():
    """The program labels its own host steps: no patching, and the span
    names appear in a profile of the calls."""
    from svdss_tpu_torch.index.fmd import build_index
    from svdss_tpu_torch.ops.fmd import DeviceFMDIndex
    from svdss_tpu_torch.pipeline import search as S
    from svdss_tpu_torch.utils.seq import encode_nt6
    assert not hasattr(P, "labelled")
    g = "ACGTTGCAAC" * 20
    index = build_index({"g": g})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert DeviceFMDIndex.from_host(index, "cpu").device.type == "cpu"
        assert S.host_search_batch(index, [encode_nt6(g[:50])]) == [[]]
    names = {e.name for e in prof.events()}
    assert {"tables: FM upload", "redo: host engine"} <= names


def test_new_tools_are_in_the_isolation_walk():
    from test_torch_isolation import imported_modules, port_sources
    sources = port_sources()
    for name in NEW_TOOLS:
        path = os.path.join(ROOT, "svdss_tpu_torch", "tools", name + ".py")
        assert path in sources
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "svdss_tpu")
                       for m in imported_modules(path))


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["--target", "anchor"], ["--target", "fm", "--jump-k", "4"],
    ["--target", "pool"], ["--target", "wide"]],
    ids=["anchor", "fm_jump", "pool", "wide"])
def test_cpu_run_says_not_measured(argv, tmp_path, capsys):
    """A --device cpu run at a tiny size: the plain versions run
    unprofiled, the line is labelled cpu, and the trace and every device
    number read "not measured"."""
    rc = P.main(argv + ["--device", "cpu", "--genome-bp", "100000",
                        "--reads", "4", "--read-len", "600",
                        "--max-iters", "96", "--workdir", str(tmp_path)])
    out = last_json(capsys.readouterr().out)
    assert rc == 0 and out["device"] == {"device": "cpu"}
    for k in ("trace", "window_ms", "device_busy_ms", "busy_share",
              "by_kernel", "by_op", "idle_gaps", "warm_s", "window_host_s"):
        assert out[k] == "not measured"
    assert out["cpu_window_host_s"] > 0 and out["launches"] == {}
    assert not any(f.startswith("profile_") for f in os.listdir(tmp_path))
    if argv[1] == "pool":
        assert out["result"]["pool_launches"] == 0
    elif argv[1] == "fm":              # stopped by the step budget
        assert out["result"]["iters"] == 96 == out["max_iters"]
    else:
        assert out["result"]["sfs"] > 0


def test_cpu_search_target_writes_the_runs_sfs(tmp_path, capsys):
    """--target search --engine fm on a `cli run --no-device` directory:
    run_search as `run` calls it, on the plain FM version, writes the
    run's specifics.txt byte for byte."""
    from svdss_tpu_torch.io.fasta import write_fasta
    from svdss_tpu_torch.utils.simulate import (make_haplotype,
                                                random_genome,
                                                simulate_reads, write_bam)
    rng = np.random.default_rng(11)
    chroms = random_genome(rng, {"chrP": 30_000})
    h1 = make_haplotype(rng, "chrP", chroms["chrP"], n_ins=1, n_del=1,
                        min_len=80, max_len=150)
    h2 = make_haplotype(rng, "chrP", chroms["chrP"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [h1, h2], coverage=4, read_len=400)
    ref, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(ref, chroms)
    write_bam(bam, chroms, recs)
    run = str(tmp_path / "run")
    assert cli.main(["run", "--reference", ref, "--bam", bam, "--workdir",
                     run, "--no-device"]) == 0
    capsys.readouterr()
    rc = P.main(["--target", "search", "--engine", "fm", "--run-workdir",
                 run, "--threads", "2", "--device", "cpu", "--workdir",
                 str(tmp_path / "prof")])
    out = last_json(capsys.readouterr().out)
    assert rc == 0 and out["device"] == {"device": "cpu"}
    assert out["result"]["specifics_identical"] is True
    assert out["result"]["reads_with_sfs"] > 0
    assert out["busy_share"] == "not measured"
    assert out["engine"] == "fm" and out["anchor_tables"] is None
