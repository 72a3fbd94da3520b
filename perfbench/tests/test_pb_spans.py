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


def test_one_shot_host_reader():
    read = reader("oneshot_host_ms_per_kread")
    t = {"host_spans": {"search: dispatch": 0.25, "search: collect": 0.75,
                        "search: pack batch": 0.1}}
    assert read(ctx(t)) == pytest.approx(1.0 * 1e3 / 2.0)
    assert read(ctx({"host_spans": {"search: collect": 0.5}})) == \
        pytest.approx(0.25 * 1e3)
    assert read(ctx(None)) is None
    assert read(ctx({"host_spans": {"pool: pump": 3.0}})) is None
    assert read(ctx(t, reads=0)) is None


def test_redo_ms_per_read_reader():
    read = reader("redo_ms_per_read")
    assert read(types.SimpleNamespace(redo_s=1.5, redone=600)) == \
        pytest.approx(2.5)
    assert read(types.SimpleNamespace(redo_s=0.0, redone=0)) is None


def test_k3_roofline_reader():
    import numpy as np
    from perfbench import roofline
    read = reader("k3_roofline")
    work = {"rounds": 10 ** 6, "table_rows": 10 ** 5, "text_rows": 10 ** 4,
            "symbols": 10 ** 7}
    c = types.SimpleNamespace(
        trace={"kernel_launches": {"K3": 4}, "kernel_s": {"K3": 0.01}},
        k3_work=work, k3_lanes=1024, k3_launches=4, reads=1000,
        lengths=np.full(1000, 10000), emissions=50000,
        tables_bytes={"small": 10 ** 9, "text_words": 10 ** 8})
    nbytes, ops = roofline.k3_bytes_ops(
        1000 * 10001 + 24 * 2, 1024, 4, 10 ** 6, 10 ** 5, 10 ** 4, 10 ** 7,
        50000, 10 ** 9, 10 ** 8)
    least, _ = roofline.bound_s(nbytes, ops)
    assert read(c) == pytest.approx(100.0 * least / 0.01)
    assert 0 < read(c) < 100
    c.k3_work = None
    assert read(c) is None
    c.k3_work, c.trace = work, None
    assert read(c) is None


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
