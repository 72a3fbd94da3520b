"""The port's search-throughput tool (svdss_tpu_torch/tools/bench.py)
against the JAX repo's bench.py and the JAX engines, on the CPU with the
kernels' plain versions: the workload byte for byte, the index, the per-read
SFS lists of K3, K2 and K2 with jumps and the redo set (tolerance 0: every
value is an integer), the pool against the host engine, `main()`'s JSON
line and its exit code, and `AnchorPool.rounds_run`."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from svdss_tpu.ops import fmd_jax
from svdss_tpu.ops.anchor_jax import (batch_search_anchor as j_anchor,
                                      build_device_anchor as j_device_anchor)
from svdss_tpu.ops.pingpong_jax import batch_search as j_fm
from svdss_tpu.utils.seq import kmer_keys
from svdss_tpu_torch.ops import anchor_device, anchor_pool
from svdss_tpu_torch.ops.anchor_pool import AnchorPool
from svdss_tpu_torch.ops.fmd import DeviceFMDIndex, build_jump_table
from svdss_tpu_torch.ops.pingpong import batch_search
from svdss_tpu_torch.pipeline.search import host_search_batch
from svdss_tpu_torch.tools import bench as tbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME_BP = 200_000
JUMP_K = 6

# the keys of bench.py's JSON line (bench.py:500-538) with the host baseline
# measured and with the pool
BENCH_KEYS = {"metric", "value", "unit", "engine", "fm_reads_per_s",
              "genome_bp", "read_len", "reads_per_s_by_len", "host_cpu",
              "smoke_ok", "smoke_lanes_checked", "pool_reads_per_s",
              "host_reads_per_s_1t", "host_reads_per_s_2t",
              "host_reads_per_s_16t_est", "host_baseline_method",
              "vs_baseline"}

torch.set_num_threads(1)


def lists(qs, ln, n):
    qs, ln, n = np.asarray(qs), np.asarray(ln), np.asarray(n)
    return [list(zip(qs[i, :n[i]].tolist(), ln[i, :n[i]].tolist()))
            for i in range(len(n))]


def redo_set(res):
    return set(np.nonzero(np.asarray(res.incomplete)
                          | np.asarray(res.overflow))[0].tolist())


@pytest.mark.parametrize("n_reads,read_len,budget",
                         [(16, 1000, 160_000), (40, 2000, 4096 * 10_000),
                          (7, 30_000, 4096 * 10_000)])
def test_workload_equals_bench(n_reads, read_len, budget):
    g = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(3).integers(0, 4, 100_000)]
    got = tbench.make_reads(g, n_reads, read_len)
    want = bench.make_reads(g, n_reads, read_len)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    for n in (n_reads, 4 * n_reads, 4 * 4096):
        assert tbench.auto_q(n, read_len, budget) == \
            bench.auto_q(n, read_len, budget)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """bench.py's problem at 200 kbp from both tools, bench.py's caches
    kept out of the repo root; the JAX and port device tables."""
    tmp = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "__file__", str(tmp / "jax" / "bench.py"))
        os.makedirs(tmp / "jax")
        jindex, jgenome = bench.build_problem(GENOME_BP, 32, 2000)
        jaidx = bench.build_anchor(jgenome, GENOME_BP)
    wd = str(tmp / "port")
    index, genome = tbench.build_problem(GENOME_BP, 32, 2000, workdir=wd)
    aidx = tbench.build_anchor(genome, GENOME_BP, workdir=wd)
    didx, params = anchor_device.build_device_anchor(aidx, "cpu")
    jdidx, jparams = j_device_anchor(jaidx)
    return dict(tmp=tmp, wd=wd, index=index, genome=genome, jindex=jindex,
                jgenome=jgenome, aidx=aidx, jaidx=jaidx, didx=didx,
                params=params, jdidx=jdidx, jparams=jparams,
                dev_index=DeviceFMDIndex.from_host(index, "cpu"),
                jdev_index=fmd_jax.DeviceFMDIndex.from_host(jindex))


def test_build_problem_equals_bench(problem):
    p = problem
    assert p["genome"].tobytes() == p["jgenome"].tobytes()
    assert p["index"].n == p["jindex"].n == 2 * GENOME_BP + 2
    for f in ("C", "occ", "bwt_words"):
        assert np.array_equal(getattr(p["index"], f),
                              getattr(p["jindex"], f))
    a, b = p["aidx"], p["jaidx"]
    assert (a.k, a.j0, a.cmax, a.n) == (b.k, b.j0, b.cmax, b.n)
    for f in ("meta", "poslist", "text"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert sorted(os.listdir(p["wd"])) == [
        f"anchor_{GENOME_BP}_16.npz", f"index_{GENOME_BP}.npz"]
    assert not any(f.startswith(".bench_") for f in os.listdir(ROOT))


@pytest.fixture(scope="module")
def reads(problem):
    return tbench.make_reads(problem["genome"], 16, 1500)


@pytest.mark.parametrize("max_rounds", [tbench.round_cap(1500), 40],
                         ids=["round_cap", "tight"])
def test_anchor_equals_jax_with_redo_set(problem, reads, max_rounds):
    """K3 as time_anchor launches it (emission cap, round cap) against
    anchor_jax: every lane's SFS list, the redo set, and time_anchor's
    counts over batches of 6 (the last 4 reads dropped, as bench.py drops
    them)."""
    p = problem
    r, ln = reads
    cap = tbench.anchor_cap(r.shape[1])
    got = anchor_device.batch_search_anchor(
        p["didx"], p["params"], torch.from_numpy(r), torch.from_numpy(ln),
        cap=cap, max_rounds=max_rounds)
    want = j_anchor(p["jdidx"], p["jparams"], jnp.asarray(r),
                    jnp.asarray(ln), cap=cap, max_rounds=max_rounds)
    assert lists(got.qs, got.length, got.n_sfs) == \
        lists(want.qs, want.length, want.n_sfs)
    redo = redo_set(want)
    assert redo_set(got) == redo
    if max_rounds == 40:
        assert len(redo) > 0
    _, _, n_sfs, _, n_redo = tbench.time_anchor(
        p["didx"], p["params"], p["index"], r, ln, 1, q=6,
        max_rounds=max_rounds)
    assert n_redo == len([i for i in redo if i < 12])
    keep = np.array([i not in redo for i in range(12)])
    assert n_sfs == int(np.asarray(want.n_sfs)[:12][keep].sum())


@pytest.mark.parametrize("jump", [False, True], ids=["plain", "jump"])
def test_fm_equals_jax(problem, reads, jump):
    """K2 as time_device launches it (cap 512), with and without the
    6-mer jump table, against pingpong_jax (its keys from kmer_keys; the
    table is the port's, which tests/test_torch_jump.py holds equal to
    fmd_jax.build_jump_table's: the JAX build takes ~50 s here), and
    every complete lane against the host engine."""
    p = problem
    r, ln = reads
    kw, jkw = {}, {}
    if jump:
        table = build_jump_table(p["dev_index"], JUMP_K)
        kw = dict(jump_table=table, jump_k=JUMP_K)
        jkw = dict(jump_table=jnp.asarray(table.numpy()),
                   keys=jnp.asarray(kmer_keys(r, JUMP_K)), jump_k=JUMP_K)
    got = batch_search(p["dev_index"], torch.from_numpy(r),
                       torch.from_numpy(ln), cap=tbench.FM_CAP, **kw)
    want = j_fm(p["jdev_index"], jnp.asarray(r), jnp.asarray(ln),
                cap=tbench.FM_CAP, **jkw)
    got_l = lists(got.qs, got.length, got.n_sfs)
    assert got_l == lists(want.qs, want.length, want.n_sfs)
    assert redo_set(got) == redo_set(want) == set()
    host = host_search_batch(p["index"],
                             [r[i, :ln[i]] for i in range(len(ln))])
    assert got_l == [[tuple(x) for x in h] for h in host]
    _, _, n_sfs, _ = tbench.time_device(p["dev_index"], r, ln, 1, **kw)
    assert n_sfs == int(np.asarray(want.n_sfs).sum())


def test_pool_stream_equals_host_engine_and_counts_rounds(problem, reads):
    """The pool over a stream of 2 chunks (4 lanes, 8 reads a chunk):
    every result equals the host engine's, and rounds_run equals the
    rounds the one-shot plain version counts for the same reads under the
    pool's budget."""
    p = problem
    r, ln = reads
    enc = [r[i, :ln[i]] for i in range(len(ln))]
    pool = AnchorPool(p["didx"], p["params"], lanes=4, read_len=1500,
                      cap=512)
    assert pool.rounds_run == 0
    got = dict(pool.run(enc))
    assert sorted(got) == list(range(len(enc)))
    want = host_search_batch(p["index"], enc)
    for i, pairs in got.items():
        assert pairs is not None and pairs == [tuple(x) for x in want[i]]
    lens_t = torch.from_numpy(ln)
    budget = anchor_pool.lane_budget(lens_t).to(torch.int32)
    work = torch.zeros(4, dtype=torch.int64)
    anchor_device.batch_search_anchor(
        p["didx"], p["params"], torch.from_numpy(r), lens_t, cap=512,
        budget=budget, max_rounds=int(budget.max()), work=work)
    assert pool.rounds_run == int(work[0]) > len(enc)
    # on the CPU the chunks run the plain version: no kernel launch
    rate, n_redo, rounds, launches = tbench.time_pool(
        p["didx"], p["params"], p["index"], r, ln, lanes=4, mult=1)
    assert (n_redo, rounds, launches) == (0, int(work[0]), 0) and rate > 0


@pytest.mark.parametrize("cap,max_rounds", [(20, 0), (512, 40), (30, 150)],
                         ids=["overflow", "round_cap", "both"])
def test_parity_holds_flagged_lanes(problem, reads, cap, max_rounds):
    """Parity.hold on K3's flagged lanes: an overflow lane holds the first
    cap SFSs of a longer host list, an incomplete one a prefix of it; with
    each host list's first SFS dropped, every lane that emitted is a
    mismatch, and with finish=True so is every incomplete lane."""
    p = problem
    r, ln = reads
    res = anchor_device.batch_search_anchor(
        p["didx"], p["params"], torch.from_numpy(r), torch.from_numpy(ln),
        cap=cap, max_rounds=max_rounds)
    want = host_search_batch(p["index"],
                             [r[i, :ln[i]] for i in range(len(ln))])
    flagged = (res.overflow | res.incomplete).numpy()
    assert flagged.any()
    par = tbench.Parity()
    par.hold("k3", res, want, cap)
    assert par.ok and par.checked == len(ln)
    assert par.flagged["k3"] == int(flagged.sum())
    shifted = tbench.Parity()
    shifted.hold("k3", res, [w[1:] for w in want], cap)
    assert shifted.mismatched["k3"] == np.nonzero(res.n_sfs.numpy())[0] \
        .tolist()
    strict = tbench.Parity()
    strict.hold("k3", res, want, cap, finish=True)
    late = (res.incomplete & ~res.overflow).numpy()
    assert strict.mismatched.get("k3", []) == np.nonzero(late)[0].tolist()


def test_check_anchor_redoes_round_capped_lanes(problem, reads):
    """check_anchor at a tight round cap, in batches of 8: every lane held,
    and every round-capped lane run again without the cap to its end."""
    p = problem
    r, ln = reads
    want = tbench.host_lists(p["index"], r, ln)
    par = tbench.Parity()
    tbench.check_anchor(par, "k3", p["didx"], p["params"], r, ln, want,
                        q=8, max_rounds=40)
    assert par.ok and par.flagged["k3"] > 0
    assert par.checked == len(ln) + par.flagged["k3"]
    assert "k3_uncapped" not in par.flagged


def test_wide_slice_host_engine_is_the_wide_oracle(problem, reads,
                                                   monkeypatch):
    """K5's oracle in the bench: the host engine over the FMD index of the
    wide tables' slice gives the wide oracle's lists, read for read."""
    from svdss_tpu_torch.ops.anchor_wide import anchor_search_wide
    monkeypatch.setattr(tbench, "WIDE_SLICE", GENOME_BP // 2)
    widx, wres, sidx = tbench.wide_slice(problem["genome"])
    assert sidx.n == 2 * (GENOME_BP // 2) + 2
    r, ln = reads
    host = tbench.host_lists(sidx, r, ln)
    for i in range(len(ln)):
        got = anchor_search_wide(widx, r[i, :ln[i]], resolver=wres)
        assert [tuple(x) for x in got] == [tuple(x) for x in host[i]]


def test_kernel_records_count_the_work(problem, reads, monkeypatch):
    """The per-kernel records the tool logs on the card, on the CPU with
    the CUDA-event timer replaced by one call: their work counts, slowest
    lanes and bounds follow from the launches they describe."""
    from svdss_tpu_torch.tools import common
    monkeypatch.setattr(common, "event_ms", lambda fn, reps: (fn(), 1.0)[1])
    p = problem
    r, ln = reads[0][:8], reads[1][:8]
    k2 = tbench.k2_record(p["dev_index"], r, ln)
    work = torch.zeros(1, dtype=torch.int64)
    res = batch_search(p["dev_index"], torch.from_numpy(r),
                       torch.from_numpy(ln), cap=tbench.FM_CAP, work=work)
    assert k2["rank_steps"] == int(work[0]) > 0 and k2["jump_rows"] == 0
    assert k2["slowest_lane_steps"] == int(res.iters)
    assert k2["bound_bytes"] == common.fm_bytes_ops(
        p["dev_index"], torch.from_numpy(ln), int(work[0]), res.n_sfs)[0]
    k3 = tbench.k3_record(p["didx"], p["params"], r, ln, 4, 40, 5)
    assert k3["launches"] == 2 and k3["host_redo"] == 5
    assert k3["slowest_lane_rounds"] == 40 and k3["work"]["rounds"] > 0
    k4 = tbench.k4_record(p["didx"], p["params"], r, ln, 2, 1, 2, 0, 7)
    assert k4["k3_under_budget_agrees"] and k4["shape"].startswith("M=4 ")
    k6 = tbench.k6_record(p["dev_index"], JUMP_K)
    assert k6["launches"] == JUMP_K - 1
    assert k6["parents"] == sum(4 ** j for j in range(1, JUMP_K))
    assert k6["bound_by"] in ("bytes", "operations")


TINY = ["--device", "cpu", "--genome-bp", "60000", "--reads", "8",
        "--read-len", "800", "--iters", "1", "--no-sweep",
        "--host-sample", "8"]


def run_main(argv, capsys):
    rc = tbench.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out


def test_main_prints_bench_line(tmp_path, capsys):
    rc, out = run_main(TINY + ["--workdir", str(tmp_path)], capsys)
    assert rc == 0 and len(out) == 1
    line = json.loads(out[0])
    assert set(line) == BENCH_KEYS
    assert line["smoke_ok"] is True and line["smoke_lanes_checked"] >= 16
    assert line["metric"] == "sfs_search_reads_per_s_per_chip"
    assert line["engine"] in ("anchor", "anchor-pool")
    assert line["genome_bp"] == 60_000 and line["read_len"] == 800


def test_main_exits_nonzero_on_a_mismatch(tmp_path, capsys, monkeypatch):
    """A host engine that returns a wrong list for one read: the parity
    check fails, smoke_ok is false and the exit code is 1."""
    real = tbench.host_search_batch

    def wrong(index, encoded, *a, **kw):
        out = real(index, encoded, *a, **kw)
        return [o + [(0, 1)] if i == 0 else o for i, o in enumerate(out)]

    monkeypatch.setattr(tbench, "host_search_batch", wrong)
    rc, out = run_main(TINY + ["--workdir", str(tmp_path), "--engine", "fm",
                               "--no-host"], capsys)
    assert rc == 1
    assert json.loads(out[-1])["smoke_ok"] is False


def test_main_check_all_holds_every_lane(tmp_path, capsys):
    """--check-all: every read of K3, K2 and the K5 waves and every read of
    the pool's stream (4 x the batch) held against the host engine."""
    rc, out = run_main(TINY + ["--workdir", str(tmp_path), "--check-all",
                               "--no-host"], capsys)
    line = json.loads(out[-1])
    assert rc == 0 and line["smoke_ok"] is True
    assert line["smoke_lanes_checked"] == 3 * 8 + 4 * 8


def test_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--workdir", str(tmp_path)])
    assert tbench.parse(["--cpu"]).device == "cpu"


def test_smoke_shape_is_bench_s():
    a = tbench.parse(["--smoke", "--device", "cpu"])
    assert (a.genome_bp, a.reads, a.read_len, a.iters) == \
        (1_000_000, 256, 2_000, 1)
    assert a.no_sweep and a.no_host and a.no_pool
