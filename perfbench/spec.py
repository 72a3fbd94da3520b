"""The benchmark's data: `BENCHMARK.json` and the files it names.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` holds it) and a traffic mix, read from
``perfbench/traffic/<traffic>.json``. Each metric, end-to-end or per-layer,
is read by ``perfbench/metrics/<name>.py``, whose ``read(ctx)`` returns a
number, or None when the run holds nothing to read. So a later change adds
a configuration, a mix or a metric as new files and new entries, and edits
none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List, Optional

BENCH_DIR = "perfbench"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[object], Optional[float]]


@dataclasses.dataclass
class Cell:
    root: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def cache_dir(self) -> str:
        """Where this configuration's index, tables and the plain
        reference's bitmaps are kept between runs (inside the checkout,
        at a fixed path)."""
        return os.path.join(self.root, BENCH_DIR, ".cache",
                            self.config["name"])


def _reader(root: str, name: str) -> Callable[[object], Optional[float]]:
    path = os.path.join(root, BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, with its files and
    metric readers."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(root, BENCH_DIR, "traffic",
                                 f"{w['traffic']}.json"))

    def here(m: dict) -> bool:
        """A metric without `workloads` is read in every cell."""
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    layer = [m for m in bench["per_layer"] if here(m)]
    return Cell(
        root=root, chips=int(w["chips"]), config=config,
        traffic=traffic,
        end_to_end=[Metric(m["name"], m["unit"], _reader(root, m["name"]))
                    for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], _reader(root, m["name"]))
                   for m in layer])

