"""The readers of the program's own spans and counters, on synthetic
contexts: a number where there is something to read; nothing without a
device trace (a run off the card), without the span or counter, or
without reads; and nothing, with no error, on a program that has no
tracing module."""

import sys
import types

import pytest

from perfbench import spec
from perfbench.tests.conftest import ROOT


def reader(name):
    return spec._reader(ROOT, name)


TRACE = {"host_spans": {}}


def ctx(trace=TRACE, reads=2000):
    return types.SimpleNamespace(trace=trace, reads=reads)


@pytest.mark.parametrize("name,span", [
    ("pool_fetch_ms_per_kread", "pool: fetch"),
    ("pool_lists_ms_per_kread", "pool: lists")])
def test_pool_span_readers(name, span):
    read = reader(name)
    t = {"host_spans": {span: 0.5, "pool: pump": 3.0}}
    assert read(ctx(t)) == pytest.approx(0.5 * 1e3 / 2.0)
    assert read(ctx(None)) is None
    assert read(ctx({"host_spans": {"pool: pump": 3.0}})) is None
    assert read(ctx(t, reads=0)) is None


def no_tracing(monkeypatch):
    """The program as it was before its tracing module."""
    import svdss_tpu_torch
    monkeypatch.delattr(svdss_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "svdss_tpu_torch.trace", None)


def registry(monkeypatch, spans=None, counters=None):
    from svdss_tpu_torch import trace
    monkeypatch.setattr(trace, "snapshot", lambda: {
        "spans": spans or {}, "counters": counters or {}})


def test_table_layout_reader(monkeypatch):
    read = reader("table_layout_s")
    registry(monkeypatch, spans={"tables: layout": {
        "calls": 2, "seconds": 30.0, "self_seconds": 30.0,
        "last_seconds": 17.5}})
    assert read(ctx()) == 17.5
    assert read(ctx(None)) is None
    registry(monkeypatch, spans={"tables: upload": {
        "calls": 1, "seconds": 3.0, "self_seconds": 3.0,
        "last_seconds": 3.0}})
    assert read(ctx()) is None
    registry(monkeypatch, spans={"tables: layout": {
        "calls": 1, "seconds": 9.0, "self_seconds": 9.0,
        "last_seconds": 9.0}})
    no_tracing(monkeypatch)
    assert read(ctx()) is None


def test_redo_rerun_reader(monkeypatch):
    read = reader("redo_rerun_pct")
    registry(monkeypatch, counters={"redo: reads": 400, "redo: rerun": 380})
    assert read(ctx()) == pytest.approx(95.0)
    assert read(ctx(None)) is None
    registry(monkeypatch, counters={"redo: reads": 400})
    assert read(ctx()) == 0.0
    registry(monkeypatch, counters={"redo: reads": 0, "redo: rerun": 0})
    assert read(ctx()) is None
    registry(monkeypatch)
    assert read(ctx()) is None
    registry(monkeypatch, counters={"redo: reads": 400, "redo: rerun": 4})
    no_tracing(monkeypatch)
    assert read(ctx()) is None
