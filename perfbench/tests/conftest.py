"""Fixtures of the benchmark's own tests.

Run them from the repository's root: ``python -m pytest perfbench/tests``
(on the CPU; the tests marked ``card`` skip without a card, and run on it
with ``python -m pytest perfbench/tests -m card``)."""

import json
import os
import shutil

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_CONFIG = {
    "name": "tiny", "source": "a test's reference",
    "reference": {"name": "chrT", "length_bp": 200000, "seed": 5},
    "tables": "narrow", "reduced": [], "assumed": []}


def tiny_program():
    """The program's Config for the tiny genome: below 2^26 symbols the
    default gate takes the FM engine, so ask for the anchor engine; a small
    emission cap sends some reads to the redo."""
    from svdss_tpu_torch.config import Config
    return Config(engine="anchor", lanes=16, max_sfs_per_read=64, threads=1)

TINY_TRAFFIC = {
    "batch_reads": 16, "set_batches": 2,
    "read_length": {"distribution": "lognormal", "median": 1500,
                    "sigma": 0.25, "min": 800, "max": 2500},
    "snv_rate": 0.002,
    "svs": [{"type": "insertion", "share": 0.2, "min": 50, "max": 300},
            {"type": "deletion", "share": 0.2, "min": 50, "max": 300}],
    "sv_margin": 100, "check": {"sample_reads": 6, "redo_reads": 6}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def write_root(path, configs, traffic, workloads, extra_metrics=None):
    """A checkout-like root: BENCHMARK.json over the repository's metric
    readers, with the given configuration and traffic files."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    os.makedirs(os.path.join(path, "perfbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "perfbench", "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "perfbench", "metrics"),
                    os.path.join(path, "perfbench", "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench["configs"] = []
    for c in configs:
        f = f"perfbench/configs/{c['name']}.json"
        json.dump(c, open(os.path.join(path, f), "w"))
        bench["configs"].append({"name": c["name"], "source": "test",
                                 "file": f, "reduced": [], "why": "test"})
    for name, t in traffic.items():
        json.dump(t, open(os.path.join(path, "perfbench", "traffic",
                                       f"{name}.json"), "w"))
    bench["workloads"] = workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m or m in bench["per_layer"]:
            m["workloads"] = [w["name"] for w in workloads]
    for m in extra_metrics or ():
        bench["per_layer"].append(m)
    json.dump(bench, open(os.path.join(path, "BENCHMARK.json"), "w"))
    return str(path)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return write_root(
        tmp_path_factory.mktemp("tiny"), [TINY_CONFIG], {"tiny": TINY_TRAFFIC},
        [{"name": "tiny.t", "config": "tiny", "traffic": "tiny", "chips": 1,
          "why": "test"}])
