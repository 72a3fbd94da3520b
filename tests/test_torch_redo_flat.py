"""The host engine's one-pass entry (svdss_tpu_torch/csrc/pingpong_flat.cpp
svdss_ping_pong_batch_flat, ops/pingpong_native.py
NativeFMD.search_batch_flat) and pipeline/search.py host_search_batch,
which takes it, against the JAX package's Python oracle and its capped
native entry on the same genome and reads, with host_search_batch's
counters."""

import os
import subprocess

import numpy as np
import pytest

from svdss_tpu.index.fmd import build_index as ref_build_index
from svdss_tpu.ops.pingpong_host import ping_pong_search as ref_search
from svdss_tpu.ops.pingpong_native import NativeFMD as RefNativeFMD
from svdss_tpu_torch import trace
from svdss_tpu_torch.index.fmd import build_index
from svdss_tpu_torch.ops.pingpong_native import NativeFMD
from svdss_tpu_torch.pipeline import search
from svdss_tpu_torch.utils.seq import encode_nt6

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libsvdss_native.so")

# novel sequence, and the prefix lengths of it that give exactly 512, 513
# and 1,025 SFSs against the genome below, at each overlap
NOVEL = np.random.default_rng(9).integers(1, 5, 9000).astype(np.uint8)
LENGTHS = {-1: (897, 898, 1759), 0: (4391, 4401, 8780)}


@pytest.fixture(scope="module", autouse=True)
def build_native():
    if not os.path.exists(NATIVE):
        subprocess.run(["make", "-C", os.path.dirname(NATIVE)], check=True)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(11)
    return {"c1": "".join("ACGT"[i] for i in rng.integers(0, 4, 20_000))}


@pytest.fixture(scope="module")
def index(genome):
    return build_index(genome)


@pytest.fixture(scope="module")
def nfmd(index):
    nf = NativeFMD(index, threads=2)
    yield nf
    nf.close()


@pytest.fixture(scope="module")
def ref_index(genome):
    return ref_build_index(genome)


@pytest.fixture(scope="module")
def ref_native(ref_index):
    nf = RefNativeFMD(ref_index, threads=2)
    yield nf
    nf.close()


def batch(genome, overlap):
    """Reads with 0 SFSs, a few, exactly 512, 513 and 1,025."""
    plain = encode_nt6(genome["c1"][3000:5000])
    few = plain.copy()
    few[[400, 900, 1500]] = 5 - few[[400, 900, 1500]]
    return [plain, few] + [NOVEL[:n] for n in LENGTHS[overlap]]


@pytest.fixture(scope="module")
def oracle(genome, ref_index):
    """The JAX package's Python oracle's lists of batch(genome, overlap),
    per overlap."""
    return {ov: [ref_search(ref_index, e, ov) for e in batch(genome, ov)]
            for ov in (-1, 0)}


def added_counters(before):
    after = trace.snapshot()["counters"]
    return {k: n - before["counters"].get(k, 0) for k, n in after.items()
            if n != before["counters"].get(k, 0)}


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("overlap", [-1, 0])
def test_flat_lists_equal_the_reference(genome, nfmd, ref_native, oracle,
                                        overlap, threads):
    """Reads of 0, a few, 512, 513 and 1,025 SFSs: one pass gives the lists
    of the reference's oracle and of its capped entry, which searches the
    last two again."""
    reads = batch(genome, overlap)
    got = nfmd.search_batch_flat(reads, overlap, threads)
    want = oracle[overlap]
    n = [len(r) for r in want]
    assert n[0] == 0 and 0 < n[1] < 50 and n[2:] == [512, 513, 1025]
    assert got == want
    assert ref_native.search_batch(reads, overlap, threads, cap=512) == want
    assert nfmd.search_batch(reads, overlap, threads, cap=512) == want


def test_flat_empty_batch_and_one_short_read(genome, ref_index, nfmd):
    assert nfmd.search_batch_flat([], -1, 4) == []
    short = encode_nt6(genome["c1"][700:800])
    short[50] = 5 - short[50]
    got = nfmd.search_batch_flat([short], -1, 4)
    assert got == [ref_search(ref_index, short, -1)]
    assert len(got[0]) > 0


@pytest.mark.parametrize("overlap", [-1, 0])
def test_host_search_lists_equal_the_reference(genome, index, ref_native,
                                               overlap, monkeypatch):
    """host_search_batch's lists, threaded, are the reference's capped
    entry's on the same reads; it counts the two lists past the cap."""
    monkeypatch.setattr(search, "_NATIVE_FMD_CACHE", {})
    reads = batch(genome, overlap)
    before = trace.snapshot()
    out = search.host_search_batch(index, reads, overlap, 4)
    counters = added_counters(before)
    assert out == ref_native.search_batch(reads, overlap, 4, cap=512)
    assert counters["redo: long lists"] == 2
    assert counters.get("redo: rerun", 0) == 0
    assert counters["redo: reads"] == len(reads)


def test_host_search_counts_a_long_list_searched_once(index, ref_index,
                                                      monkeypatch):
    """A novel 4,000 bp read passes the first cap: one long list, no
    rerun."""
    monkeypatch.setattr(search, "_NATIVE_FMD_CACHE", {})
    novel = np.random.default_rng(9).integers(1, 5, 4000).astype(np.uint8)
    before = trace.snapshot()
    out = search.host_search_batch(index, [novel], -1, 4)
    counters = added_counters(before)
    assert isinstance(search._NATIVE_FMD_CACHE[id(index)], NativeFMD)
    assert out == [ref_search(ref_index, novel, -1)]
    assert len(out[0]) > search.NATIVE_FIRST_CAP
    assert counters["redo: long lists"] == 1
    assert counters.get("redo: rerun", 0) == 0
    assert counters["redo: reads"] == 1
