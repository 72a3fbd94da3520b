"""The scale harness (svdss_tpu_torch/tools/) on the CPU at a tiny size:
each tool end to end with --device cpu (plain versions of K2 and K5, its
oracle in a worker process) reports 0 mismatches; on the same genome and
reads its per-read SFS lists and fallback flags equal the JAX package's
own functions (anchor_wide_jax.batch_search_anchor_wide one shot and
WideWaveRun in waves, pingpong_jax.batch_search on a force-wide
fmd_jax.DeviceFMDIndex); its genome and read generators equal the JAX
repo's tools; a cached stage is reused, and one stamped under another
scheme is refused. Integer results: equality is exact."""

import ast
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import build_index as j_build_index
from svdss_tpu.ops import anchor_wide_jax as jw
from svdss_tpu.ops import fmd_jax, pingpong_jax
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu.ops.anchor_wide import make_heavy_resolver as j_resolver
from svdss_tpu_torch.tools import common as C
from svdss_tpu_torch.tools import giant_fm, giant_wide, repeat_wide

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 500         # read length of the tiny runs


@pytest.fixture(autouse=True)
def narrow_batches(monkeypatch):
    """The search stage pads a batch to at least 256 lanes, which the plain
    version of K5 steps through in every round; the lanes are independent,
    so the tiny runs take batches of 16."""
    from svdss_tpu_torch.pipeline.search import _DeviceSearcher
    monkeypatch.setattr(_DeviceSearcher, "lanes_for", lambda self, L: 16)


def quiet(_msg):
    pass


def jax_tool(name):
    """A module of the JAX repo's tools/ (its top level imports numpy
    only; the JAX package is imported inside its main)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_gen_reads(g6, n_reads, read_len, insertions=True):
    """The read generator of tools/giant_wide.py:146 (gen_reads) and
    tools/giant_validation.py:97, as written there; without the insertion
    rows, that of tools/repeat_validation.py:166."""
    rr = np.random.default_rng(7)
    reads = np.zeros((n_reads, read_len + 1), dtype=np.uint8)
    lens = np.full(n_reads, read_len, dtype=np.int32)
    starts = rr.integers(0, len(g6) - read_len, n_reads)
    reads[:, :read_len] = g6[starts[:, None] + np.arange(read_len)]
    cols = rr.integers(0, read_len,
                       (n_reads, max(1, int(read_len * 0.002))))
    rows = np.repeat(np.arange(n_reads), cols.shape[1])
    reads[rows, cols.ravel()] = rr.integers(1, 5, cols.size)
    if insertions:
        ins_rows = np.nonzero(rr.random(n_reads) < 0.3)[0]
        for i in ins_rows:
            at = int(rr.integers(200, read_len - 200))
            ins = rr.integers(1, 5, 100).astype(np.uint8)
            reads[i, at + 100:read_len] = reads[i, at:read_len - 100].copy()
            reads[i, at:at + 100] = ins
    return reads, lens


def test_generators_equal_the_jax_tools():
    def chrom_nt6(seed, n):        # tools/giant_wide.py:105
        return np.random.default_rng(seed).integers(1, 5, n,
                                                    dtype=np.uint8)
    for seed, n in ((1000, 5_000), (1003, 777)):
        assert np.array_equal(C.chrom_nt6(seed, n), chrom_nt6(seed, n))
    # tools/giant_wide.py:178-183: chromosomes joined by one 0 each
    parts = []
    for i in range(3):
        parts += [chrom_nt6(1000 + i, 2_000_000), np.zeros(1, np.uint8)]
    assert np.array_equal(C.forward_genome(2, 3),
                          np.concatenate(parts[:-1]))
    g6 = chrom_nt6(1000, 50_000)
    for ins in (True, False):
        got = C.snv_reads(g6, 40, 600, insertions=ins)
        want = jax_gen_reads(g6, 40, 600, insertions=ins)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    rv = jax_tool("repeat_validation")
    for n in (300_000, 1_000_000):
        want = rv.build_repeat_genome(np.random.default_rng(4242), n,
                                      log=quiet)
        rng = np.random.default_rng(4242)
        got = C.build_repeat_genome(rng, n, log=quiet)
        assert np.array_equal(got, want)
        # the phase sample goes on drawing from the same generator state
        jrng = np.random.default_rng(4242)
        rv.build_repeat_genome(jrng, n, log=quiet)
        assert rng.integers(0, 1 << 30) == jrng.integers(0, 1 << 30)


def test_tools_import_neither_jax_nor_the_jax_repo():
    pkg = os.path.join(ROOT, "svdss_tpu_torch", "tools")
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert {"giant_wide.py", "giant_fm.py", "repeat_wide.py"} <= set(files)
    for f in files:
        tree = ast.parse(open(os.path.join(pkg, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            assert not {m.split(".")[0] for m in mods} \
                & {"jax", "jaxlib", "svdss_tpu", "tools"}, (f, mods)


def lists_of(res, n):
    qs, ln = np.asarray(res.qs), np.asarray(res.length)
    k = np.asarray(res.n_sfs)
    bad = np.asarray(res.overflow) | np.asarray(res.incomplete)
    return ([list(map(list, zip(qs[i, :k[i]].tolist(),
                                ln[i, :k[i]].tolist()))) for i in range(n)],
            bad.astype(int).tolist())


@pytest.mark.parametrize("sort", ["right", "full"])
def test_giant_wide_matches_jax(tmp_path, sort):
    wd = str(tmp_path / "gw")
    argv = ["--device", "cpu", "--chrom-mbp", "1", "--n-chrom", "2",
            "--reads", "12", "--read-len", str(L), "--qs", "6,12",
            "--verify", "12", "--workers", "1", "--engine", "anchor",
            "--sort", sort, "--workdir", wd]
    rep = giant_wide.main(argv, log=quiet)
    assert rep["ok"] and rep["mismatches"] == 0
    assert rep["oracle_verified_reads"] + rep[
        "oracle_fallback_on_device_resolved"] == rep["device_resolved_reads"]
    assert rep["engine"] == "wide anchor, parked-phase waves"
    assert rep["sort"] == sort and [c["Q"] for c in rep["configs"]] == [6, 12]
    assert all(c["cross_mismatch"] == 0 for c in rep["configs"][1:])
    with open(os.path.join(wd, "device.json")) as f:
        dump = json.load(f)
    text = C.forward_genome(1, 2)
    reads, lens = jax_gen_reads(C.chrom_nt6(1000, 1_000_000), 12, L)
    jidx = j_build_anchor_index_wide(
        text, cmax=44, sort_buckets="right" if sort == "right" else True)
    jdev, jparams = jw.build_device_anchor_wide(jidx)
    Q = rep["configs"][0]["Q"]
    want = jw.batch_search_anchor_wide(jdev, jparams,
                                       jnp.asarray(reads[:Q]),
                                       jnp.asarray(lens[:Q]),
                                       cap=dump["oneshot_cap"])
    wl, wb = lists_of(want, Q)
    assert dump["oneshot_lists"] == wl and dump["oneshot_bad"] == wb
    # the searcher's lists (waves, host redo) equal JAX's complete lanes
    for i in range(Q):
        if not wb[i]:
            assert dump["lists"][i] == wl[i]
    # a second run finds every stage cached and gives the same verdict
    again = giant_wide.main(argv, log=quiet)
    assert again["ok"] and again["mismatches"] == 0
    for name in ("genome", "tables", "upload"):   # not run again
        assert again["stages"][name] == rep["stages"][name]


def test_giant_fm_matches_jax(tmp_path):
    wd = str(tmp_path / "gf")
    rep = giant_fm.main(["--device", "cpu", "--chrom-mbp", "1", "--n-chrom",
                         "2", "--reads", "10", "--read-len", str(L),
                         "--oracle", "4", "--workers", "1", "--force-wide",
                         "--threads", "2", "--workdir", wd], log=quiet)
    assert rep["ok"] and rep["mismatches"] == 0
    assert rep["oracle_mismatches"] == 0 and rep["oracle_lanes"] == 4
    assert rep["wide"] and not rep["wide_by_size"]
    with open(os.path.join(wd, "device.json")) as f:
        dump = json.load(f)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chroms = {f"chr{i + 1}": bases[C.chrom_nt6(1000 + i, 1_000_000) - 1]
              .tobytes().decode() for i in range(2)}
    jdev = fmd_jax.DeviceFMDIndex.from_host(j_build_index(chroms),
                                            force_wide=True)
    reads, lens = jax_gen_reads(C.chrom_nt6(1000, 1_000_000), 10, L)
    want = pingpong_jax.batch_search(jdev, jnp.asarray(reads),
                                     jnp.asarray(lens), cap=dump["cap"])
    wl, wb = lists_of(want, 10)
    assert dump["lists"] == wl and dump["bad"] == wb


def test_repeat_wide_matches_jax(tmp_path):
    wd = str(tmp_path / "rw")
    rep = repeat_wide.main(["--device", "cpu", "--fwd-mbp", "1", "--cmax",
                            "44", "--reads", "48", "--read-len", str(L),
                            "--verify", "48", "--batches", "2",
                            "--sample-phases", "5000", "--workers", "1",
                            "--workdir", wd], log=quiet)
    assert rep["ok"] and rep["mismatches"] == 0
    assert rep["resolve_waves"] > 0 and rep["heavy_kmer_slots"] > 0
    assert not rep["wide_by_size"]
    with open(os.path.join(wd, "device.json")) as f:
        dump = json.load(f)
    rv = jax_tool("repeat_validation")
    text = rv.build_repeat_genome(np.random.default_rng(4242), 1_000_000,
                                  log=quiet)
    reads, lens = jax_gen_reads(text, 48, L, insertions=False)
    jidx = j_build_anchor_index_wide(text, cmax=44)
    jdev, jparams = jw.build_device_anchor_wide(jidx)
    resolver = j_resolver(jidx)
    cap = dump["cap"]

    def resolve(base):
        def fn(lanes, ancs, dirbs):
            return np.array([resolver(reads[base + ln, :L], int(a),
                                      "left" if d == 1 else "right")
                             for ln, a, d in zip(lanes, ancs, dirbs)],
                            dtype=np.int32)
        return fn
    runs = [jw.WideWaveRun(jdev, jparams, jnp.asarray(reads[b:b + 24]),
                           jnp.asarray(lens[b:b + 24]), resolve(b), cap=cap)
            for b in (0, 24)]
    parts = jw.WideWaveScheduler(runs).finish_all()
    got_l, got_b = [], []
    for p in parts:
        pl, pb = lists_of(p, 24)
        got_l += pl
        got_b += pb
    assert dump["lists"] == got_l and dump["bad"] == got_b
    one = jw.batch_search_anchor_wide(jdev, jparams,
                                      jnp.asarray(reads[:24]),
                                      jnp.asarray(lens[:24]), cap=cap)
    assert (dump["oneshot_lists"], dump["oneshot_bad"]) == lists_of(one, 24)


def test_stamps_refuse_another_scheme(tmp_path):
    wd = C.Workdir(str(tmp_path), {"scheme": "a", "n": 1})
    assert not wd.ready("x")                      # absent
    open(wd.path("x"), "w").close()
    assert not wd.ready("x")                      # unstamped: unfinished
    wd.stamp("x")
    assert wd.ready("x")
    with pytest.raises(C.StaleArtifact):
        C.Workdir(str(tmp_path), {"scheme": "a", "n": 2}).ready("x")
    # a tool refuses a genome cached under another generation scheme
    gw = tmp_path / "gw"
    gw.mkdir()
    (gw / "genome.npy").write_bytes(b"")
    (gw / "genome.npy.scheme.json").write_text(json.dumps(
        {"scheme": "chrom_nt6-per-chrom", "seeds": "1000+i",
         "chrom_mbp": 2, "n_chrom": 2}))
    with pytest.raises(C.StaleArtifact):
        giant_wide.main(["--device", "cpu", "--chrom-mbp", "1",
                         "--n-chrom", "2", "--workdir", str(gw)], log=quiet)


def test_tools_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (giant_wide, giant_fm, repeat_wide):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(["--workdir", str(tmp_path / mod.__name__)], log=quiet)
