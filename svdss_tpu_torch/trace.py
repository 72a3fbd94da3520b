"""Spans and counters of the port's host side.

    with trace.span("pool: fetch"):
        ...
    trace.count("pool: chunks")

A span adds, on exit, to a registry kept per name for the life of the
process: its calls, its seconds (``time.perf_counter``), its self seconds
(its seconds less what spans opened inside it on the same thread took)
and the seconds of its last call. A counter adds whole numbers. While a
torch profiler is recording, a span also opens
``torch.profiler.record_function`` under its name, so that it lies in the
profiler's trace on the clock of the device events; otherwise it costs two
clock reads and a locked dict update. There is nothing to switch on.

`snapshot()` gives the registry as a plain dict; `summary(since=)` the
one-line text of it, or of what was added since an earlier snapshot
(``run_search`` logs one over each call). Spans sit around chunks, batches,
groups and builds, never around single bases.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler

_lock = threading.Lock()
# name -> [calls, seconds, self seconds, last call's seconds]
_spans: Dict[str, list] = {}
_counters: Dict[str, int] = {}
# per thread: the seconds of child spans of each open span, innermost last
_open = threading.local()


def _profiling() -> bool:
    return bool(getattr(_profiler, "_is_profiler_enabled", False))


class span:
    """Context manager: time the block under `name` (see the module)."""

    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(0.0)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        stack = _open.stack
        inner = stack.pop()
        if stack:
            stack[-1] += dt
        with _lock:
            s = _spans.get(self.name)
            if s is None:
                s = _spans[self.name] = [0, 0.0, 0.0, 0.0]
            s[0] += 1
            s[1] += dt
            s[2] += dt - inner
            s[3] = dt
        if self._rf is not None:
            self._rf.__exit__(*exc)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def traced(name: str):
    """Decorator: run the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def snapshot() -> dict:
    """{"spans": {name: {"calls", "seconds", "self_seconds",
    "last_seconds"}}, "counters": {name: n}} as they stand."""
    with _lock:
        return {"spans": {k: {"calls": c, "seconds": s, "self_seconds": ss,
                              "last_seconds": last}
                          for k, (c, s, ss, last) in _spans.items()},
                "counters": dict(_counters)}


def summary(since: Optional[dict] = None) -> str:
    """One line: each span's seconds, self seconds and calls, then each
    counter; with `since` (an earlier `snapshot()`), what was added after
    it."""
    now = snapshot()
    old = since or {"spans": {}, "counters": {}}
    parts = []
    for k in sorted(now["spans"]):
        v = now["spans"][k]
        o = old["spans"].get(k, {"calls": 0, "seconds": 0.0,
                                 "self_seconds": 0.0})
        calls = v["calls"] - o["calls"]
        if calls:
            parts.append(f"{k} {v['seconds'] - o['seconds']:.3f} s "
                         f"(self {v['self_seconds'] - o['self_seconds']:.3f}"
                         f") x{calls}")
    for k in sorted(now["counters"]):
        n = now["counters"][k] - old["counters"].get(k, 0)
        if n:
            parts.append(f"{k} {n}")
    return "; ".join(parts) if parts else "no spans"
