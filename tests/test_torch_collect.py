"""_DeviceSearcher.collect against the JAX package's, on the CPU: the same
batch through both searchers (the FM engine, the narrow anchor engine and
the wide anchor engine), with an emission cap small enough that lanes
overflow and are redone on the host.

- ``collect(h)`` returns the finished per-read lists, redos done inline;
- ``collect(h, defer_redo=True)`` returns ``(lists, None | (redo,
  future))`` with the redo slots None, and the lists equal once patched;
- an empty batch gives ``[]`` and ``([], None)``;
- ``device_reads`` and ``fallbacks`` count as the JAX searcher's do, and
  ``search_batch`` equals the JAX one.

Integer results: equality is exact."""

import numpy as np
import pytest
import torch

from svdss_tpu.config import Config as JConfig
from svdss_tpu.index.fmd import build_index as j_build_index
from svdss_tpu.index.fmd import genome_text as j_genome_text
from svdss_tpu.ops.anchor import build_anchor_index as j_build_anchor_index
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu.pipeline import search as j_search
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.index.fmd import build_index, genome_text
from svdss_tpu_torch.ops.anchor import build_anchor_index
from svdss_tpu_torch.ops.anchor_wide import build_anchor_index_wide
from svdss_tpu_torch.pipeline import search
from svdss_tpu_torch.utils.seq import encode_nt6

from test_torch_anchor import corpus, random_genome

torch.set_num_threads(1)

CAP = 16          # small enough that SFS-dense reads overflow


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 20_000)
    return genome, corpus(np.random.default_rng(5), genome, n=18)


def searchers(genome, engine):
    """The port's and the JAX package's searcher over the same tables."""
    cfg = dict(engine="fm" if engine == "fm" else "anchor", lanes=16,
               max_sfs_per_read=CAP)
    if engine == "fm":
        mine_t = theirs_t = None
    elif engine == "anchor":
        mine_t = build_anchor_index(genome_text(genome))
        theirs_t = j_build_anchor_index(j_genome_text(genome))
    else:
        fwd = encode_nt6(genome["c1"])
        mine_t = build_anchor_index_wide(fwd)
        theirs_t = j_build_anchor_index_wide(fwd)
    mine = search._DeviceSearcher(build_index(genome), Config(**cfg), "cpu",
                                  mine_t)
    theirs = j_search._DeviceSearcher(j_build_index(genome), JConfig(**cfg),
                                      theirs_t)
    assert mine.wide == (engine == "wide")
    assert (mine.anchor is None) == (engine == "fm")
    return mine, theirs


def patched(pair):
    out, deferred = pair
    out = list(out)
    if deferred is not None:
        redo, fut = deferred
        for i, r in zip(redo, fut.result()):
            out[i] = r
    return out


@pytest.mark.parametrize("engine", ["fm", "anchor", "wide"])
def test_collect_matches_jax(sample, engine):
    genome, reads = sample
    mine, theirs = searchers(genome, engine)
    try:
        got = mine.collect(mine.dispatch(reads))
        want = theirs.collect(theirs.dispatch(reads))
        assert isinstance(got, list) and got == want
        assert all(g is not None for g in got) and sum(map(len, got)) > 0
        assert mine.fallbacks == theirs.fallbacks > 0

        got_d = mine.collect(mine.dispatch(reads), defer_redo=True)
        want_d = theirs.collect(theirs.dispatch(reads), defer_redo=True)
        assert isinstance(got_d, tuple) and len(got_d) == 2
        assert got_d[0] == want_d[0]
        assert got_d[1] is not None and want_d[1] is not None
        assert got_d[1][0] == want_d[1][0]
        assert all(got_d[0][i] is None for i in got_d[1][0])
        assert patched(got_d) == patched(want_d) == got

        assert mine.collect(mine.dispatch([])) == \
            theirs.collect(theirs.dispatch([])) == []
        assert mine.collect(mine.dispatch([]), defer_redo=True) == \
            theirs.collect(theirs.dispatch([]), defer_redo=True) == ([], None)
        assert mine.search_batch(reads) == theirs.search_batch(reads) == got
        assert mine.device_reads == theirs.device_reads == 3 * len(reads)
        assert mine.fallbacks == theirs.fallbacks
    finally:
        mine.close()
        theirs_close = getattr(theirs, "_redo_exec", None)
        if theirs_close is not None:
            theirs_close.shutdown()


def test_collect_without_redo_returns_none_deferred(sample):
    """A batch no lane of which needs the host: the list alone, or the
    pair with None, as the JAX searcher returns them."""
    genome, reads = sample
    mine, theirs = searchers(genome, "fm")
    short = [r[:40] for r in reads[:6]]
    try:
        got = mine.collect(mine.dispatch(short), defer_redo=True)
        want = theirs.collect(theirs.dispatch(short), defer_redo=True)
        assert got == want and got[1] is None
        assert mine.collect(mine.dispatch(short)) == got[0]
        assert mine.fallbacks == theirs.fallbacks == 0
        assert mine.device_reads == 2 * len(short)
    finally:
        mine.close()
