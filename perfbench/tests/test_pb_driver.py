"""The window's drivers give run_search's lists: the same reads of a
small smoothed BAM, fed in batches through the pool or the bucketed
one-shot loop (the kernels' plain versions on the CPU), against
``run_search`` with the same Config."""

import hashlib
import inspect

import numpy as np
import pytest

from perfbench.driver import BucketDriver, PoolDriver, bucket_len, driver_for


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    from svdss_tpu_torch.config import Config
    from svdss_tpu_torch.index.fmd import build_index, genome_text
    from svdss_tpu_torch.ops.anchor import build_anchor_index
    from svdss_tpu_torch.pipeline.smooth import run_smooth
    from svdss_tpu_torch.utils.simulate import (make_haplotype,
                                                random_genome,
                                                simulate_reads, write_bam)
    rng = np.random.default_rng(4242)
    tmp = tmp_path_factory.mktemp("pbdriver")
    chroms = random_genome(rng, {"chrD": 60000})
    hap1 = make_haplotype(rng, "chrD", chroms["chrD"], n_ins=10, n_del=8,
                          min_len=60, max_len=300)
    hap2 = make_haplotype(rng, "chrD", chroms["chrD"], n_ins=0, n_del=0)
    recs = simulate_reads(rng, [hap1, hap2], coverage=10, read_len=2500,
                          snv_rate=0.002, indel_rate=0.0005)
    bam = str(tmp / "reads.bam")
    write_bam(bam, chroms, recs)
    smoothed = str(tmp / "smoothed.bam")
    run_smooth(Config(use_device=False), chroms, bam, smoothed)
    return dict(smoothed=smoothed, index=build_index(chroms),
                anchor=build_anchor_index(genome_text(chroms)))


@pytest.mark.parametrize("lanes,cap,batch", [(16, 128, 7), (8, 24, 50)])
def test_driver_lists_equal_run_search(sample, lanes, cap, batch):
    from svdss_tpu_torch.config import Config
    from svdss_tpu_torch.pipeline import search
    cfg = Config(engine="anchor", lanes=lanes, max_sfs_per_read=cap,
                 threads=1)
    want = search.run_search(cfg, sample["index"], bam=sample["smoothed"],
                             device="cpu", anchor=sample["anchor"])
    reads = [(q, search.encode_nt6(s), hp) for q, s, hp in
             search.eligible_reads_bam(sample["smoothed"], True)]
    searcher = search._DeviceSearcher(sample["index"], cfg, "cpu",
                                      sample["anchor"])
    d = PoolDriver(searcher, cfg, keep=lambda t: True)
    for i in range(0, len(reads), batch):
        d.hand(reads[i:i + batch])
    d.finish()
    got = d.lists()
    names = [q for q, _, _ in reads]
    assert len(got) == len(reads) > 60
    assert [(q, p) for q, p in ((names[t], got[t]) for t in sorted(got))
            if p] == [(q, [(s.qs, s.l) for s in g]) for q, g in want]
    assert not np.isnan(d.done_at).any() and d.stray == 0
    # a read is complete when emitted, in stream order
    assert (np.diff(d.done_at) >= 0).all()
    assert len(d.pools) >= 1 and d.pools[-1] is d.pool
    if cap == 24:                # the small cap sends reads to the redo
        assert d.redone and searcher.fallbacks == len(d.redone)


@pytest.mark.parametrize("lanes,cap,batch", [(16, 128, 7), (8, 24, 50)])
def test_bucket_driver_lists_equal_run_search(sample, lanes, cap, batch):
    """The batches handed are one stream of run_search's bucketed branch,
    ended by finish: every read's list is run_search's (pool=False) over
    the whole BAM."""
    from svdss_tpu_torch.config import Config
    from svdss_tpu_torch.pipeline import search
    cfg = Config(engine="anchor", lanes=lanes, max_sfs_per_read=cap,
                 threads=1, pool=False)
    want = search.run_search(cfg, sample["index"], bam=sample["smoothed"],
                             device="cpu", anchor=sample["anchor"])
    reads = [(q, search.encode_nt6(s), hp) for q, s, hp in
             search.eligible_reads_bam(sample["smoothed"], True)]
    searcher = search._DeviceSearcher(sample["index"], cfg, "cpu",
                                      sample["anchor"])
    searcher.smoothed_input = True      # as run_search sets it for a BAM
    d = BucketDriver(searcher, cfg, keep=lambda t: True)
    for i in range(0, len(reads), batch):
        d.hand(reads[i:i + batch])
    # the branch emits nothing before its input ends
    assert np.isnan(d.done_at).all() and d.lists() == {}
    d.finish()
    assert not np.isnan(d.done_at).any()
    got = d.lists()
    names = [q for q, _, _ in reads]
    assert len(got) == len(reads) > 60
    assert [(q, p) for q, p in ((names[t], got[t]) for t in sorted(got))
            if p] == [(q, [(s.qs, s.l) for s in g]) for q, g in want]
    assert d.stray == 0 and (np.diff(d.done_at) >= 0).all()
    if cap == 24:                # the small cap sends reads to the redo
        assert d.redone and searcher.fallbacks == len(d.redone)


def test_bucket_len_is_run_search_s():
    from svdss_tpu_torch.pipeline import search
    for n in (1, 511, 512, 513, 5000, 15000, 16384, 16385, 25000):
        assert bucket_len(n) == search._bucket_len(n)


def test_driver_refuses_another_engine(sample):
    from svdss_tpu_torch.config import Config
    from svdss_tpu_torch.pipeline import search
    cfg = Config(engine="fm", threads=1)
    s = search._DeviceSearcher(sample["index"], cfg, "cpu", None)
    with pytest.raises(ValueError):
        PoolDriver(s, cfg, keep=lambda t: False)


@pytest.mark.parametrize("engine,pool,want", [
    ("anchor", True, PoolDriver), ("anchor", False, BucketDriver),
    ("fm", True, BucketDriver)])
def test_driver_for_follows_run_search_s_gate(sample, engine, pool, want):
    from svdss_tpu_torch.config import Config
    from svdss_tpu_torch.pipeline import search
    cfg = Config(engine=engine, threads=1, pool=pool)
    s = search._DeviceSearcher(sample["index"], cfg, "cpu",
                               sample["anchor"] if engine == "anchor"
                               else None)
    assert driver_for(s, cfg) is want
    other = BucketDriver if want is PoolDriver else PoolDriver
    with pytest.raises(ValueError):
        other(s, cfg, keep=lambda t: False)


# sha256 of run_search's emit and pool loop (svdss_tpu_torch/pipeline/
# search.py) as perfbench/driver.py copies them
POOL_LOOP_SHA256 = (
    "5934b47a71e657df514181853d31393b5880e95560d6f09cb6fd77d5b30fe141")


def test_run_search_pool_loop_is_the_one_the_driver_copies():
    """The driver replays run_search's pool loop, its emit and its redo
    schedule: when that source changes, this fails until driver.py follows
    it (and the digest is brought up to date with it)."""
    from svdss_tpu_torch.pipeline import search
    src = inspect.getsource(search.run_search)
    emit = src[src.index("    def emit("):src.index("    if searcher is None:")]
    start = src.index("    elif searcher.anchor is not None and not "
                      "searcher.wide and config.pool:")
    loop = src[start:src.index("\n    else:\n", start) + 1]
    assert "AnchorPool(" in loop and ">= 256" in loop
    got = hashlib.sha256((emit + loop).encode()).hexdigest()
    assert got == POOL_LOOP_SHA256, (
        "run_search's pool loop changed: bring perfbench/driver.py to it")


# sha256 of run_search's emit and bucketed one-shot branch, as
# perfbench/driver.py BucketDriver copies them
BUCKET_LOOP_SHA256 = (
    "609bd2e1af5d8c097ba919ea1a76ba2903d0786e464a1d586888d5af39140c1a")


def test_run_search_bucket_loop_is_the_one_the_driver_copies():
    """BucketDriver replays run_search's bucketed branch (its buckets,
    dispatch and drain, the deferred redo and the emit in stream order):
    when that source changes, this fails until driver.py follows it."""
    from svdss_tpu_torch.pipeline import search
    src = inspect.getsource(search.run_search)
    emit = src[src.index("    def emit("):src.index("    if searcher is None:")]
    start = src.index("    else:\n        # accumulate per length bucket")
    loop = src[start:src.index("    dt = time.time() - t0", start)]
    assert "searcher.dispatch(" in loop and "defer_redo=True" in loop
    got = hashlib.sha256((emit + loop).encode()).hexdigest()
    assert got == BUCKET_LOOP_SHA256, (
        "run_search's bucketed loop changed: bring perfbench/driver.py to it")
