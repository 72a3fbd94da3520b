"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the result line's keys, the driver the program's gate picks,
`correct` false under each fault the cell can have, the trace arithmetic,
additions as new files only, and the isolation from JAX and the JAX
package."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import driver, faults, harness, run, spec, trace
from perfbench.tests.conftest import (ROOT, TINY_CONFIG, TINY_TRAFFIC,
                                      tiny_program, write_root)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def run_tiny(root, seconds=1.5, trace_=False, workload="tiny.t", seed=SEED,
             cfg=None):
    cell = spec.load_cell(root, workload)
    return harness.run_cell(cell, seed, seconds, trace_, CPU,
                            time.perf_counter(), cfg or tiny_program())


TINY_WIDE = dict(TINY_CONFIG, name="tinyw", wide=True)


@pytest.fixture(scope="module")
def bucket_root(tmp_path_factory):
    """Cells whose searcher leaves the pool: the mix with ``pool: false``,
    and a configuration stated wide."""
    return write_root(
        tmp_path_factory.mktemp("tinyb"), [TINY_CONFIG, TINY_WIDE],
        {"tiny": TINY_TRAFFIC, "tinynp": dict(TINY_TRAFFIC, pool=False)},
        [{"name": "tiny.np", "config": "tiny", "traffic": "tinynp",
          "chips": 1, "why": "test"},
         {"name": "tiny.t", "config": "tiny", "traffic": "tiny",
          "chips": 1, "why": "test"},
         {"name": "tinyw.t", "config": "tinyw", "traffic": "tiny",
          "chips": 1, "why": "test"}])


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
                                   "redo_read_pct.oneshot",
                                   "redo_ms_per_read",
                                   "search_rate_kbp_per_s"}
    assert out["metrics"]["redo_read_pct"]["value"] > 0
    assert out["metrics"]["redo_ms_per_read"]["value"] > 0


@pytest.mark.parametrize("case", ["pool_false", "wide", "engine_fm"])
def test_the_gate_picks_the_bucket_driver(bucket_root, case, monkeypatch):
    """Off the pool path the harness drives run_search's bucketed loop
    through set-up, window and check, with no edit to the harness."""
    workload, cfg = {
        "pool_false": ("tiny.np", None),
        "wide": ("tinyw.t", None),
        "engine_fm": ("tiny.t", dataclasses.replace(tiny_program(),
                                                    engine="fm"))}[case]
    if case == "wide":
        monkeypatch.setenv("SVDSS_TPU_WIDE_ANCHOR", "1")
    made = []
    orig = driver.BucketDriver.__init__

    def spy(self, searcher, *a, **kw):
        made.append((searcher.anchor is not None, searcher.wide,
                     searcher.dev is not None))
        orig(self, searcher, *a, **kw)
    monkeypatch.setattr(driver.BucketDriver, "__init__", spy)
    monkeypatch.setattr(driver.PoolDriver, "__init__", None)
    out, lines = run_tiny(bucket_root, workload=workload, cfg=cfg)
    assert out["correct"] is True and out["failed"] == 0, lines
    assert out["attempted"] >= 16
    # the warm-up's driver and the window's, on the engine the case asks
    assert made == [{"pool_false": (True, False, False),
                     "wide": (True, True, False),
                     "engine_fm": (False, False, True)}[case]] * 2


def test_a_configuration_stated_otherwise_is_refused(bucket_root,
                                                     monkeypatch):
    monkeypatch.delenv("SVDSS_TPU_WIDE_ANCHOR", raising=False)
    with pytest.raises(RuntimeError, match="states wide"):
        run_tiny(bucket_root, workload="tinyw.t")
    monkeypatch.setenv("SVDSS_TPU_WIDE_ANCHOR", "1")
    with pytest.raises(RuntimeError, match="states narrow"):
        run_tiny(bucket_root, workload="tiny.np")


def test_one_shot_work_is_counted_in_a_traced_window(bucket_root):
    """A traced window hands K3 its work counters; the lists stay exact."""
    cell = spec.load_cell(bucket_root, "tiny.np")
    setup = harness.Setup(cell, SEED, CPU, time.perf_counter(),
                          tiny_program())
    n = len(setup.reads.reads)
    sample = harness.sample_of(setup)
    win = harness.Window(setup, 0.5, True, keep=lambda t: (t % n) in sample,
                         trace_path=os.path.join(cell.cache_dir, "t.json"))
    ctx = harness.context(setup, win)
    assert ctx.k3_work["rounds"] > 0 and ctx.k3_work["symbols"] > 0
    assert ctx.k3_lanes >= ctx.reads and ctx.k3_lanes % 256 == 0
    assert ctx.k2_work is None and ctx.k5_work is None and \
        ctx.k4_work is None
    assert set(ctx.launches) == {"K2", "K3", "K4", "K5"}
    assert ctx.tables_bytes["small"] > 0 and ctx.pool_s is None
    want = harness.reference_lists(setup, sorted(sample), CPU)
    assert harness.compare(setup, win, want)["mismatched_reads"] == 0
    from svdss_tpu_torch.pipeline import search
    assert not hasattr(search.batch_search_anchor, "__wrapped__") and \
        search.batch_search_anchor.__module__.endswith("anchor_device")


def test_set_up_loads_the_native_library_with_the_cache_ready(
        tiny_root, monkeypatch):
    """A checkout that finds its tables built still loads (and where it
    lacks it, builds) the native library, so the host redo never runs the
    Python engine."""
    from svdss_tpu_torch.io import native
    cell = spec.load_cell(tiny_root, "tiny.t")
    harness.Setup(cell, SEED, CPU, time.perf_counter(), tiny_program())
    assert os.path.exists(os.path.join(cell.cache_dir, "TABLES_READY"))
    calls = []
    orig = native.load
    monkeypatch.setattr(native, "load",
                        lambda: calls.append(1) or orig())
    s = harness.Setup(cell, SEED, CPU, time.perf_counter(), tiny_program())
    assert calls == [1] and s.build_s is None


def test_set_up_refuses_a_run_without_the_native_library(tiny_root,
                                                          monkeypatch):
    """Without the native library the host redo would run the Python
    engine: set-up stops, and the run prints no result."""
    from svdss_tpu_torch.io import native
    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native library"):
        run_tiny(tiny_root)


RUNS = {"pool": ("tiny.t", "tiny_root"), "bucket": ("tiny.np", "bucket_root")}


@pytest.mark.parametrize("fault,path", [
    pytest.param(f, p, id=f if i == 0 else f"{f}-{p}")
    for f in sorted(faults.FAULTS) for i, p in enumerate(faults.PATHS[f])])
def test_a_fault_makes_correct_false(request, fault, path):
    """Each fault in a run of each loop it acts on (the tiny cells redo
    some reads on either)."""
    workload, root = RUNS[path]
    with faults.planted(fault):
        out, lines = run_tiny(request.getfixturevalue(root),
                              workload=workload)
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
