"""Reading a torch.profiler Chrome trace: device busy time, idle gaps and
kernel time.

The interval arithmetic (`union`, `clip`, `busy`, `idle_gaps`,
`Intervals`, `split`) is a frozen copy of
``svdss_tpu_torch/tools/profile.py`` at commit 2516ced: busy time is the
union of kernel, memcpy and memset intervals, and an idle gap is named by
the innermost host event open at its middle (a label, an aten op, a CUDA
API call or the profiler's own work; "python" where none is). The
benchmark keeps its own copy so that a change to the program's tools
cannot move its yardstick.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("user_annotation", "cpu_op")
API_CATS = ("cuda_runtime", "cuda_driver")
OVERHEAD_CATS = ("overhead",)
TOP = 10


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Sorted, merged [start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(merged: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in merged if b > lo and a < hi]


def busy(merged: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> float:
    """The time in [lo, hi) covered by the merged intervals."""
    return sum(b - a for a, b in clip(merged, lo, hi))


def idle_gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The uncovered stretches of [lo, hi), longest first."""
    gaps, t = [], lo
    for a, b in clip(merged, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


class Intervals:
    """Host events, for the question: which is the innermost (shortest)
    one open at time t (its start <= t < its end)?"""

    def __init__(self, events: Sequence[dict]):
        self.events = list(events)
        self.ts = np.array([e["ts"] for e in self.events], dtype=np.float64)
        self.dur = np.array([e["dur"] for e in self.events],
                            dtype=np.float64)

    def innermost(self, t: float) -> Optional[dict]:
        open_ = (self.ts <= t) & (t < self.ts + self.dur)
        if not open_.any():
            return None
        return self.events[int(np.argmin(np.where(open_, self.dur,
                                                  np.inf)))]


def host_name(e: Optional[dict]) -> str:
    return "python" if e is None else e["name"]


def split(events: Sequence[dict]) -> Tuple[list, list, list, list]:
    """The trace's complete events as (device, host ops and labels, CUDA
    API calls, the profiler's own work)."""
    full = [e for e in events if e.get("ph") == "X" and "dur" in e]
    return tuple([e for e in full if e.get("cat") in cats]
                 for cats in (DEVICE_CATS, HOST_OP_CATS, API_CATS,
                              OVERHEAD_CATS))


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def analyse(events: Sequence[dict], label: str, seconds: float,
            kernels: Dict[str, str]) -> dict:
    """What the benchmark reads from a trace (times in the trace's µs):

    - over the window, from the start of the host label `label` for
      `seconds`: device busy seconds, the window's seconds, the device
      operations that took most time and the longest idle gaps, each
      named by the host event open at its middle;
    - over the whole trace: each kernel's summed device seconds and
      launches, for `kernels` = {name: substring of its __global__
      name}."""
    dev, host, api, overhead = split(events)
    win = [e for e in host if e["name"] == label]
    if not win:
        raise RuntimeError(f"the trace holds no {label!r} event")
    lo = win[0]["ts"]
    hi = lo + seconds * 1e6
    merged = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    everything = Intervals(host + api + overhead)
    in_win = [e for e in dev if e["ts"] + e["dur"] > lo and e["ts"] < hi]
    by_name: Dict[str, float] = {}
    for e in in_win:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    for a, b in idle_gaps(merged, lo, hi)[:TOP]:
        gaps.append([host_name(everything.innermost((a + b) / 2)),
                     (b - a) / 1e6])
    ktime = {k: [0.0, 0] for k in kernels}
    for e in dev:
        for k, sub in kernels.items():
            if e.get("cat") == "kernel" and sub in e["name"]:
                ktime[k][0] += e["dur"] / 1e6
                ktime[k][1] += 1
    spans: Dict[str, float] = {}
    for e in host:
        if e.get("cat") == "user_annotation" and e["ts"] < hi \
                and e["ts"] + e["dur"] > lo:
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            spans[e["name"]] = spans.get(e["name"], 0.0) + (b - a) / 1e6
    return {"busy_s": busy(merged, lo, hi) / 1e6, "window_s": seconds,
            "host_spans": spans,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps,
            "kernel_s": {k: v[0] for k, v in ktime.items()},
            "kernel_launches": {k: v[1] for k, v in ktime.items()}}
