"""The port stands alone: no file of svdss_tpu_torch/, nor chip_smoke.py,
imports jax or the svdss_tpu package, and every entry point runs on the
card unless the caller asks for the CPU — without a card it raises instead
of carrying on quietly on the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

from svdss_tpu_torch import cli
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.index.fmd import build_index, genome_text
from svdss_tpu_torch.ops.align_dp import batch_align
from svdss_tpu_torch.ops.anchor import build_anchor_index
from svdss_tpu_torch.ops.anchor_device import (batch_search_anchor,
                                               build_device_anchor)
from svdss_tpu_torch.ops.anchor_wide import (build_anchor_index_wide,
                                             make_heavy_resolver)
from svdss_tpu_torch.ops.anchor_wide_device import (
    batch_search_anchor_wide, batch_search_anchor_wide_waves,
    build_device_anchor_wide)
from svdss_tpu_torch.ops.fmd import DeviceFMDIndex, build_jump_table
from svdss_tpu_torch.ops.pingpong import batch_search, pack_reads
from svdss_tpu_torch.pipeline.call import run_call
from svdss_tpu_torch.pipeline.search import run_search
from svdss_tpu_torch.utils.device import resolve_device
from svdss_tpu_torch.utils.seq import encode_nt6

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_sources():
    pkg = os.path.join(ROOT, "svdss_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = port_sources()
    assert len(sources) > 40 and os.path.exists(sources[0])
    bad = []
    for path in sources:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "svdss_tpu"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    rng = np.random.default_rng(3)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
    return {"g": g}, build_index({"g": g})


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_kernel_entry_points_default_to_cuda(no_cuda, tiny):
    chroms, index = tiny
    with pytest.raises(RuntimeError):
        DeviceFMDIndex.from_host(index)
    with pytest.raises(RuntimeError):
        pack_reads([np.ones(4, dtype=np.uint8)])
    pair = [(np.array([1, 2, 3], dtype=np.int32),
             np.array([1, 2, 4], dtype=np.int32))]
    with pytest.raises(RuntimeError):
        batch_align(pair)
    aidx = build_anchor_index(genome_text(chroms))
    with pytest.raises(RuntimeError):
        build_device_anchor(aidx)
    # the same calls with device="cpu" run the plain versions (the jump
    # table is built on its index's device)
    dev = DeviceFMDIndex.from_host(index, "cpu")
    seqs, lens = pack_reads([np.ones(4, dtype=np.uint8)], device="cpu")
    assert int(batch_search(dev, seqs, lens).n_sfs[0]) >= 0
    table = build_jump_table(dev, 3)
    assert table.device == torch.device("cpu") and table.shape == (64, 4)
    assert int(batch_search(dev, seqs, lens, jump_table=table,
                            jump_k=3).n_sfs[0]) >= 0
    assert batch_align(pair, device="cpu")[0][0] < 0
    adev, params = build_device_anchor(aidx, "cpu")
    assert int(batch_search_anchor(adev, params, seqs, lens).n_sfs[0]) >= 0


def test_wide_entry_points_default_to_cuda(no_cuda, tiny):
    """The wide path's entry points: the wide FM table and the wide anchor
    engine's tables raise without a card; with device="cpu" the plain
    versions run."""
    chroms, index = tiny
    with pytest.raises(RuntimeError):
        DeviceFMDIndex.from_host(index, force_wide=True)
    widx = build_anchor_index_wide(encode_nt6(chroms["g"]), k=8, cmax=16)
    with pytest.raises(RuntimeError):
        build_device_anchor_wide(widx)
    dev = DeviceFMDIndex.from_host(index, "cpu", force_wide=True)
    seqs, lens = pack_reads([np.ones(4, dtype=np.uint8)], device="cpu")
    assert dev.wide and int(batch_search(dev, seqs, lens).n_sfs[0]) >= 0
    wdev, params = build_device_anchor_wide(widx, "cpu")
    assert int(batch_search_anchor_wide(wdev, params, seqs,
                                        lens).n_sfs[0]) >= 0
    res = batch_search_anchor_wide_waves(wdev, params, seqs, lens,
                                         make_heavy_resolver(widx))
    assert int(res.n_sfs[0]) >= 0


def test_stage_entry_points_default_to_cuda(no_cuda, tiny, tmp_path):
    chroms, index = tiny
    fq = tmp_path / "r.fq"
    fq.write_text("@r\n" + chroms["g"][100:300] + "\n+\n" + "I" * 200 + "\n")
    with pytest.raises(RuntimeError):
        run_search(Config(use_device=True), index, fastx=str(fq))
    with pytest.raises(RuntimeError):
        run_call(Config(use_device=True), chroms, "missing.bam", {})
    got = run_search(Config(use_device=True), index, fastx=str(fq),
                     device="cpu")
    assert got == run_search(Config(use_device=False), index, fastx=str(fq))


def test_cli_defaults_to_cuda(no_cuda, tiny, tmp_path):
    chroms, index = tiny
    idx = str(tmp_path / "i.npz")
    index.save(idx)
    with pytest.raises(RuntimeError):
        cli.main(["search", "--index", idx, "--fastx", "x.fq"])
    # --engine anchor needs the index's anchor tables, which `save` alone
    # does not write
    with pytest.raises(SystemExit):
        cli.main(["search", "--index", idx, "--fastx", "x.fq",
                  "--device", "cpu", "--engine", "anchor"])
