"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the result line's keys, `correct` false under each fault the
cell can have, the trace arithmetic, additions as new files only, and the
isolation from JAX and the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import faults, harness, run, spec, trace
from perfbench.tests.conftest import (ROOT, TINY_CONFIG, TINY_TRAFFIC,
                                      tiny_program, write_root)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def run_tiny(root, seconds=1.5, trace_=False, workload="tiny.t", seed=SEED):
    cell = spec.load_cell(root, workload)
    return harness.run_cell(cell, seed, seconds, trace_, CPU,
                            time.perf_counter(), tiny_program())


def test_result_line(tiny_root):
    out, lines = run_tiny(tiny_root)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 16
    assert set(out["metrics"]) == {"search_kbp_per_s", "read_p95_ms",
                                   "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"] == {k: {"value": 0, "limit": 0}
                             for k in harness.LIMITS}
    assert lines[-1] == "correct True"
    assert [ln.split()[1] for ln in lines[:-1]] == list(harness.LIMITS)
    json.dumps(out)


def test_per_layer_line(tiny_root):
    """On the CPU there is no device trace: the readers of the trace find
    nothing and their metrics are left out."""
    out, _ = run_tiny(tiny_root, trace_=True)
    assert set(out["metrics"]) == {"table_upload_s",
                                   "pool_call_ms_per_kread",
                                   "redo_read_pct",
                                   "search_rate_kbp_per_s"}
    assert out["metrics"]["redo_read_pct"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_makes_correct_false(tiny_root, fault):
    with faults.planted(fault):
        out, lines = run_tiny(tiny_root)
    assert out["correct"] is False
    assert lines[-1] == "correct False"
    bad = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    assert bad, out["checks"]


def test_trace_arithmetic():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        ev("user_annotation", "perfbench: window", 1000.0, 9000.0),
        ev("user_annotation", "pool: pump", 1500.0, 2000.0),
        ev("kernel", "void anchor_pool_kernel<1>(x)", 2000.0, 500.0),
        ev("kernel", "void anchor_pool_kernel<1>(x)", 2300.0, 400.0),
        ev("gpu_memcpy", "Memcpy DtoH", 4000.0, 1000.0),
        ev("kernel", "void anchor_pool_kernel<1>(x)", 12000.0, 100.0),
        ev("cuda_runtime", "cudaLaunchKernel", 1990.0, 5.0),
    ]
    out = trace.analyse(events, "perfbench: window", 0.005,
                        {"K4": "anchor_pool_kernel"})
    # the window is [1000, 6000) µs: busy [2000, 2700) and [4000, 5000)
    assert out["busy_s"] == pytest.approx(1700e-6)
    assert out["window_s"] == 0.005
    assert out["device_ops"][0] == ["Memcpy DtoH", pytest.approx(1e-3)]
    assert out["device_ops"][1] == ["void anchor_pool_kernel<1>(x)",
                                    pytest.approx(900e-6)]
    # gaps [2700, 4000), [1000, 2000), [5000, 6000), longest first, each
    # named by the innermost host event open at its middle
    assert [g[0] for g in out["idle_gaps"]] == [
        "pool: pump", "pool: pump", "perfbench: window"]
    assert [g[1] for g in out["idle_gaps"]] == pytest.approx(
        [1300e-6, 1000e-6, 1000e-6])
    # kernel time over the whole trace, the drain's launch included
    assert out["kernel_s"]["K4"] == pytest.approx(1000e-6)
    assert out["kernel_launches"]["K4"] == 3


def test_additions_are_new_files_only(tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new
    file and a new BENCHMARK.json entry, are found by name and run."""
    conf = dict(TINY_CONFIG, name="tiny_b",
                reference={"name": "chrB", "length_bp": 150000, "seed": 8})
    mix = dict(TINY_TRAFFIC, batch_reads=12,
               read_length={"distribution": "fixed", "median": 1200},
               svs=[{"type": "insertion", "share": 0.5, "min": 100,
                     "max": 100}])
    metric = {"name": "reads_handed", "unit": "reads", "better": "higher",
              "source": "program_counter", "layer": "search driver",
              "moves": "search_kbp_per_s"}
    root = write_root(tmp_path, [TINY_CONFIG, conf],
                      {"tiny": TINY_TRAFFIC, "fixed_ins": mix},
                      [{"name": "tiny_b.fixed_ins", "config": "tiny_b",
                        "traffic": "fixed_ins", "chips": 1, "why": "test"}],
                      extra_metrics=[metric])
    with open(os.path.join(root, "perfbench", "metrics",
                           "reads_handed.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.reads)\n")
    out, _ = run_tiny(root, trace_=True, workload="tiny_b.fixed_ins")
    assert out["metrics"]["reads_handed"]["value"] == out["attempted"]
    assert out["correct"] is True
    out, _ = run_tiny(root, workload="tiny_b.fixed_ins")
    assert out["correct"] is True and "reads_handed" not in out["metrics"]


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "svdss_tpu": 1, "svdss_tpu.cli": 1, "svdss_tpu_torch": 1,
            "svdss_tpu_torch.cli": 1, "jaxtyping": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "svdss_tpu",
        "svdss_tpu.cli"]


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "perfbench"
            elif node.module:
                yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_jax_package():
    pb = os.path.join(ROOT, "perfbench")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pb) for f in fs
             if f.endswith(".py")]
    assert len(files) > 15
    for f in files:
        assert not set(_imports(f)) & set(harness.FORBIDDEN), f
    # the plain reference imports nothing of the program, nor of the
    # benchmark's files that do
    ref = set(_imports(os.path.join(pb, "reference.py")))
    assert ref <= {"__future__", "os", "typing", "numpy", "torch"}, ref


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = ("import sys, time, torch; from perfbench import harness, spec; "
            "from perfbench.tests.conftest import tiny_program; "
            "cell = spec.load_cell(sys.argv[1], 'tiny.t'); "
            "harness.run_cell(cell, 7, 0.5, False, torch.device('cpu'), "
            "time.perf_counter(), tiny_program()); "
            "print(harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code, tiny_root], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tiny_root, monkeypatch, capsys):
    monkeypatch.chdir(tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "tiny.t", "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "from perfbench import run; sys.exit(run.main(sys.argv[1:]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, "--workload",
                        "chr22.hifi_sv", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "program is not in this checkout" in r.stderr
