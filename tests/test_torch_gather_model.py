"""The port's gather cost model (svdss_tpu_torch/tools/gather_model.py,
the JAX repo's tools/gather_model.py) on the CPU at a tiny grid: the
tables and indices are the JAX tool's draws in its order, each timed sum
equals numpy's exactly and the JAX tool's int32 sum modulo 2^32, the
card-built tables' sums equal index_select's, and the JSON line of a
``--device cpu`` run is labelled cpu with "not measured" in every device
number."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu_torch.tools import gather_model as G

GRID = [(1000, 48), (500, 2), (64, 128)]
QS = [64, 256]


def jax_tool_draws(grid, qs):
    """tools/gather_model.py's loop (:47-60), its draws without its
    timing."""
    rng = np.random.default_rng(0)
    out = []
    for n_rows, width in grid:
        table = rng.integers(0, 100, (n_rows, width), dtype=np.int32)
        for q in qs:
            for mode in ("rand", "sort"):
                ix = rng.integers(0, n_rows, q).astype(np.int32)
                if mode == "sort":
                    ix = np.sort(ix)
                out.append((table, q, mode, ix))
    return out


def test_draws_are_the_jax_tools():
    want = jax_tool_draws(GRID, QS)
    got = [(t, q, m, ix) for _, t, idx in G.jax_points(GRID, QS)
           for q, m, ix in idx]
    assert len(got) == len(want) == len(GRID) * len(QS) * 2
    for (t, q, m, ix), (wt, wq, wm, wix) in zip(got, want):
        assert (q, m) == (wq, wm)
        assert t.dtype == wt.dtype and np.array_equal(t, wt)
        assert ix.dtype == wix.dtype and np.array_equal(ix, wix)


@pytest.mark.parametrize("high", [100, 2 ** 30], ids=["grid", "wraps"])
def test_sum_equals_numpy_and_jax_mod_2_32(high):
    rng = np.random.default_rng(5)
    table = rng.integers(0, high, (300, 8), dtype=np.int32)
    ix = rng.integers(0, 300, 4096).astype(np.int32)
    got = int(G.gather_sum(torch.from_numpy(table),
                           torch.from_numpy(ix).long()))
    assert got == int(table[ix].sum(dtype=np.int64))
    want_jax = int(jnp.sum(jnp.asarray(table)[jnp.asarray(ix)],
                           dtype=jnp.int32))
    assert (got - want_jax) % 2 ** 32 == 0
    if high > 100:
        assert got != want_jax            # the JAX tool's sum wrapped


def test_card_built_tables_check_their_sums(capsys):
    pts = G.run_port_tables([("tiny a", 4 * 4 * 1000, 4),
                             ("tiny b", 4 * 16 * 50, 16)], [64], torch.device(
                                 "cpu"), None)
    assert [(p["table"], p["rows"], p["width"], p["mode"]) for p in pts] == [
        ("tiny a", 1000, 4, "rand"), ("tiny a", 1000, 4, "sort"),
        ("tiny b", 50, 16, "rand"), ("tiny b", 50, 16, "sort")]
    assert all(p["sum_ok"] and p["ns_per_row"] == "not measured"
               and p["cpu_ns_per_row"] > 0 for p in pts)
    assert "(cpu)" in capsys.readouterr().out


def test_cpu_run_line(capsys):
    rc = G.main(["--device", "cpu", "--grid", "jax", "--points",
                 "1000x48,500x2", "--qs", "64,4096"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0 and line["sums_ok"] and line["device"] == {"device": "cpu"}
    assert line["l2_flush_bytes"] == 0
    pts = line["points"]
    assert [(p["rows"], p["width"], p["q"], p["mode"], p["reps"])
            for p in pts] == [
        (r, w, q, m, 20 if q == 4096 else 5)
        for r, w in ((1000, 48), (500, 2)) for q in (64, 4096)
        for m in ("rand", "sort")]
    draws = jax_tool_draws([(1000, 48), (500, 2)], [64, 4096])
    assert [p["sum"] for p in pts] == [int(t[ix].sum(dtype=np.int64))
                                       for t, _, _, ix in draws]
    for p in pts:
        assert p["ms"] == p["ns_per_row"] == "not measured"
        assert p["cpu_ms"] > 0
    assert sum(ln.startswith("rows=") for ln in out) == len(pts)
