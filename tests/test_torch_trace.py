"""svdss_tpu_torch/trace.py, the port's spans and counters, and where the
program places them: the pool's host steps, the host engine's redo and
the narrow tables' layout and upload (on the CPU, with the plain
versions)."""

import threading
import time

import numpy as np
import pytest
import torch

from svdss_tpu_torch import trace
from svdss_tpu_torch.index.fmd import build_index, genome_text
from svdss_tpu_torch.ops.anchor import build_anchor_index
from svdss_tpu_torch.ops.anchor_device import build_device_anchor
from svdss_tpu_torch.ops.anchor_pool import AnchorPool
from svdss_tpu_torch.pipeline import search
from svdss_tpu_torch.utils.seq import encode_nt6


def added(before, after=None):
    """What the registry gained since `before`: ({span: [calls, seconds,
    self seconds]}, {counter: n}), entries that did not move left out."""
    after = after or trace.snapshot()
    spans = {}
    for k, v in after["spans"].items():
        o = before["spans"].get(k, {"calls": 0, "seconds": 0.0,
                                    "self_seconds": 0.0})
        if v["calls"] != o["calls"]:
            spans[k] = [v["calls"] - o["calls"], v["seconds"] - o["seconds"],
                        v["self_seconds"] - o["self_seconds"]]
    counters = {k: n - before["counters"].get(k, 0)
                for k, n in after["counters"].items()
                if n != before["counters"].get(k, 0)}
    return spans, counters


def test_nested_spans_across_two_threads():
    """Calls, seconds and self seconds: a child span is taken out of its
    parent's self seconds on its own thread only."""
    before = trace.snapshot()
    go = threading.Barrier(2, timeout=10)

    def nest():
        go.wait()
        with trace.span("test: outer"):
            time.sleep(0.02)
            with trace.span("test: inner"):
                time.sleep(0.03)

    t = threading.Thread(target=nest)
    t.start()
    with trace.span("test: main"):
        nest()
    t.join(timeout=10)
    assert not t.is_alive()
    spans, _ = added(before)
    outer, inner, main = (spans[k] for k in ("test: outer", "test: inner",
                                             "test: main"))
    assert outer[0] == inner[0] == 2 and main[0] == 1
    assert inner[1] >= 0.06 and outer[1] >= 0.1
    assert outer[2] == pytest.approx(outer[1] - inner[1], abs=1e-9)
    assert inner[2] == pytest.approx(inner[1], abs=1e-9)
    # the main thread's outer span alone sits inside "test: main"
    assert 0.0 <= main[2] < main[1] - 0.045
    last = trace.snapshot()["spans"]["test: inner"]["last_seconds"]
    assert 0.03 <= last <= inner[1]


def test_counters_snapshot_and_summary():
    trace.count("test: things", 3)
    since = trace.snapshot()
    trace.count("test: things", 2)
    trace.count("test: other")
    with trace.span("test: summed"):
        pass

    @trace.traced("test: decorated")
    def twice(x):
        return 2 * x

    assert twice(4) == 8 and twice.__name__ == "twice"
    snap = trace.snapshot()
    assert snap["counters"]["test: things"] - \
        since["counters"]["test: things"] == 2
    assert snap["spans"]["test: decorated"]["calls"] >= 1
    line = trace.summary(since=since)
    assert "\n" not in line
    assert "test: things 2" in line and "test: other 1" in line
    assert "test: summed " in line and "test: decorated " in line
    assert "x1" in line
    whole = trace.summary()
    assert "test: things" in whole and whole != line
    # nothing added: the difference is empty
    assert trace.summary(since=trace.snapshot()) == "no spans"


def test_span_opens_record_function_only_under_the_profiler():
    with trace.span("test: unprofiled") as s:
        assert s._rf is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("test: profiled") as s:
            assert s._rf is not None
            torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert "test: profiled" in names and "test: unprofiled" not in names
    with trace.span("test: after") as s:
        assert s._rf is None


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)
    genome = {"c1": "".join("ACGT"[i] for i in rng.integers(0, 4, 20_000))}
    aidx = build_anchor_index(genome_text(genome), cmax=16)
    return genome, aidx


def test_table_layout_and_upload_spans(tables):
    _, aidx = tables
    before = trace.snapshot()
    dev, _ = build_device_anchor(aidx, "cpu")
    spans, counters = added(before)
    assert spans["tables: layout"][0] == spans["tables: upload"][0] == 1
    assert counters["tables: bytes uploaded"] == (
        dev.small.numel() * 4 + dev.text_words.numel() * 4)
    assert trace.snapshot()["spans"]["tables: layout"]["last_seconds"] \
        == pytest.approx(spans["tables: layout"][1])


def test_pool_spans_once_a_chunk_and_flag_counts(tables):
    """The plain K4 pool at a cap small enough to overflow: each host step
    is one span a chunk, and the flag counters add up to the reads
    returned as None."""
    genome, aidx = tables
    dev, params = build_device_anchor(aidx, "cpu")
    enc = encode_nt6(genome["c1"])
    rng = np.random.default_rng(5)
    reads = []
    for i in range(20):
        s = int(rng.integers(0, len(enc) - 300))
        r = enc[s:s + 300].copy()
        if i % 4 == 1:
            r[150] = 5                          # an N: the exact path
        if i % 4 == 2:
            r = rng.integers(1, 5, 300).astype(np.uint8)   # overflows
        reads.append(r)
    before = trace.snapshot()
    pool = AnchorPool(dev, params, lanes=4, read_len=300, cap=8)
    got = dict(pool.run(reads))
    spans, counters = added(before)
    chunks = -(-len(reads) // pool.M)
    assert counters["pool: chunks"] == chunks
    assert counters["pool: reads launched"] == len(reads)
    for k in ("pool: pack", "pool: launch", "pool: fetch", "pool: lists"):
        assert spans[k][0] == chunks, k
    # no copy stream and no device event on the CPU
    assert "pool: copy in" not in spans and "pool: wait" not in spans
    nones = sum(v is None for v in got.values())
    assert counters.get("pool: flagged overflow", 0) > 0
    assert counters.get("pool: flagged fallback", 0) > 0
    assert counters["pool: flagged overflow"] \
        + counters["pool: flagged fallback"] == nones
    # qs and length [m, cap] int32, n_sfs int32 and flags uint8 a read
    assert counters["pool: bytes fetched"] == len(reads) * (8 * 8 + 5)


def test_host_redo_counts_the_native_rerun(tables):
    """A read with more than the native engine's first cap of SFSs is
    counted as a long list and, searched once by the one-pass entry, not
    as rerun; a read of the genome is neither."""
    genome, _ = tables
    index = build_index(genome)
    enc = encode_nt6(genome["c1"])
    novel = np.random.default_rng(9).integers(1, 5, 4000).astype(np.uint8)
    plain = enc[3000:5000].copy()
    search.host_search_batch(index, [plain[:200]], -1, 1)   # open it
    before = trace.snapshot()
    out = search.host_search_batch(index, [novel, plain], -1, 1)
    spans, counters = added(before)
    assert len(out[0]) > search.NATIVE_FIRST_CAP >= len(out[1])
    assert counters["redo: reads"] == 2
    assert counters["redo: bases"] == len(novel) + len(plain)
    assert counters["redo: long lists"] == 1
    assert counters.get("redo: rerun", 0) == 0
    assert spans["redo: host engine"][0] == 1
    before = trace.snapshot()
    search.host_search_batch(index, [plain], -1, 1)
    _, counters = added(before)
    assert counters.get("redo: long lists", 0) == 0
    assert counters.get("redo: rerun", 0) == 0
    assert counters["redo: reads"] == 1
