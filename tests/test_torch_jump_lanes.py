"""The count of kernel K6 (svdss_tpu_torch/csrc/jump.cu, `jump_level`),
held on the CPU by a numpy mirror of its arithmetic, vectorised over the
parents of a level:

- words w and w + 16 of a fused row packed into one (nibbles 0-3 of each),
  four packed words bit-transposed into the planes b0, b1, b2 of the nibble
  codes, one mask a group from the offset, five popcounts a group, and the
  six symbol counts derived from them;
- one row's planes for both endpoints when lo and hi share a row, the
  checkpoint differences otherwise, and the children of an absent parent
  written as (C[c], x1, 0, 0) with no count.

The mirror's tables equal `jump_level_plain` / `build_jump_table_plain` and
`svdss_tpu.ops.fmd_jax.build_jump_table` at k = 1 to 8 on a genome with N
runs and repeats, and its levels on built parents whose endpoints sit at
offsets 0, 1, 63, 64 and 127, in one row and in two. Integer results:
equality is exact."""

import numpy as np
import pytest
import torch

from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops import fmd_jax
from svdss_tpu_torch.ops import fmd as tfmd

M5, M3 = np.uint32(0x55555555), np.uint32(0x33333333)
U32 = np.uint32
EDGE_OFFSETS = (0, 1, 63, 64, 127)

torch.set_num_threads(1)


# ------------------------------------------------------ the kernel's mirror

def load_planes(fused, rows):
    """jump.cu load_planes for each row index: ([m, 4] b0, b1, b2)."""
    w = fused[rows, 16:48].view(U32)
    y = ((w[:, :16] & U32(0xFFFF)) | (w[:, 16:] << U32(16))).reshape(
        -1, 4, 4)                                   # __byte_perm(.., 0x5410)
    y0, y1, y2, y3 = (y[:, :, j] for j in range(4))
    a0 = (y0 & M5) | ((y1 & M5) << U32(1))
    a1 = ((y0 >> U32(1)) & M5) | (y1 & ~M5)
    a2 = (y2 & M5) | ((y3 & M5) << U32(1))
    a3 = ((y2 >> U32(1)) & M5) | (y3 & ~M5)
    b0 = (a0 & M3) | ((a2 & M3) << U32(2))
    b1 = a1 | (a3 << U32(2))
    b2 = ((a0 >> U32(2)) & M3) | (a2 & ~M3)
    return b0, b1, b2


def popc(x):
    return np.bitwise_count(x).astype(np.int64)


def counts(planes, off):
    """jump.cu counts: [m, 5] counts of $, A, C, G, T below each offset."""
    b0, b1, b2 = planes
    k = (off >> 5).astype(np.uint64)
    full = (((np.uint64(1) << (np.uint64(4) * k)) - np.uint64(1))
            * np.uint64(0x10001)).astype(U32)
    words = ((np.uint64(1) << (off & 31).astype(np.uint64))
             - np.uint64(1)).astype(U32)
    p = np.zeros((len(off), 5), dtype=np.int64)
    for g in range(4):
        m = full | (((words >> U32(4 * g)) & U32(0x000F000F))
                    << (U32(4) * k.astype(U32)))
        for i, plane in enumerate((b0[:, g], b1[:, g], b2[:, g],
                                   b0[:, g] & b1[:, g],
                                   b0[:, g] & b2[:, g])):
            p[:, i] += popc(plane & m)
    p0, p1, p2, pg, pn = p.T
    return np.stack([off - p0 - p1 - p2 + pg + pn, p0 - pg - pn, p1 - pg,
                     pg, p2 - pn], axis=1)


def order_below(cnt):
    """below[o - 1] for o = 1..4: $, $+T, $+T+G, $+T+G+C."""
    return np.cumsum(cnt[:, [0, 4, 3, 2]], axis=1)


def mirror_level(fused, C, parents, kinds=None):
    """jump_level_kernel over every parent: the [4n, 4] children. `kinds`
    (a dict) gains the parents that were absent, in one row, in two."""
    fused = np.ascontiguousarray(fused, dtype=np.int32)
    par = np.asarray(parents, dtype=np.int64)
    n = len(par)
    out = np.zeros((4, n, 4), dtype=np.int64)
    live = par[:, 2] > 0
    for c in range(1, 5):                      # absent: no read, no count
        out[c - 1, ~live] = np.stack(
            [np.full((~live).sum(), C[c]), par[~live, 1],
             np.zeros((~live).sum()), np.zeros((~live).sum())], axis=1)
    idx = np.flatnonzero(live)
    lo = par[idx, 0]
    hi = lo + par[idx, 2]
    rl, rh = lo >> 7, hi >> 7
    same = rl == rh
    pl = load_planes(fused, rl)
    cl = counts(pl, lo & 127)
    chi = np.empty_like(cl)
    chi[same] = counts(tuple(b[same] for b in pl), hi[same] & 127)
    two = ~same
    chi[two] = counts(load_planes(fused, rh[two]), hi[two] & 127)
    occ_lo = fused[rl, 1:5].astype(np.int64)
    d_occ = np.zeros_like(occ_lo)
    d_ord = np.zeros_like(occ_lo)
    d_occ[two] = fused[rh[two], 1:5] - occ_lo[two]
    d_ord[two] = fused[rh[two], 9:13].astype(np.int64) - fused[rl[two], 9:13]
    bl, bh = order_below(cl), order_below(chi)
    for c in range(1, 5):
        o = 5 - c
        out[c - 1, idx, 0] = C[c] + occ_lo[:, c - 1] + cl[:, c]
        out[c - 1, idx, 1] = par[idx, 1] + d_ord[:, o - 1] + bh[:, o - 1] \
            - bl[:, o - 1]
        out[c - 1, idx, 2] = d_occ[:, c - 1] + chi[:, c] - cl[:, c]
    if kinds is not None:
        kinds["absent"] = kinds.get("absent", 0) + int((~live).sum())
        kinds["one_row"] = kinds.get("one_row", 0) + int(same.sum())
        kinds["two_rows"] = kinds.get("two_rows", 0) + int(two.sum())
        for name, off in (("lo", lo & 127), ("hi", hi & 127)):
            for e in EDGE_OFFSETS:
                key = f"{name}_off{e}"
                kinds[key] = kinds.get(key, 0) + int((off == e).sum())
    return out.reshape(4 * n, 4).astype(np.int32)


def mirror_table(fused, C, k, kinds=None):
    C = np.asarray(C, dtype=np.int64)
    c = np.arange(1, 5)
    rows = np.stack([C[c], C[5 - c], C[c + 1] - C[c], np.zeros(4, np.int64)],
                    axis=1).astype(np.int32)
    for _ in range(1, k):
        rows = mirror_level(fused, C, rows, kinds)
    return rows


# ----------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def setup():
    """A 12 kb genome: random, a 300 bp unit 6 times, an N run, random with
    scattered Ns; both packages' tables over one fused table."""
    rng = np.random.default_rng(77)

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    unit = rand(300)
    tail = list(rand(4_000))
    for at in rng.integers(0, len(tail), 12):
        tail[at] = "N"
    g = rand(5_000) + unit * 6 + "N" * 40 + rand(1_000) + "".join(tail)
    index = build_index({"g": g, "h": rand(900) + "NN" + rand(300)})
    jdev = fmd_jax.DeviceFMDIndex.from_host(index)
    tdev = tfmd.DeviceFMDIndex.from_arrays(np.asarray(jdev.fused),
                                           np.asarray(jdev.C), device="cpu")
    return dict(index=index, jdev=jdev, tdev=tdev,
                fused=tdev.fused.numpy(), C=tdev.C.numpy())


@pytest.fixture(scope="module")
def jax_tables(setup):
    cache = {}

    def table(k):
        if k not in cache:
            cache[k] = np.asarray(fmd_jax.build_jump_table(
                setup["jdev"], k, chunk=1 << 12))
        return cache[k]
    return table


# -------------------------------------------------------------------- tests

def test_genome_has_n_in_bwt(setup):
    """The index's BWT holds N symbols, which the derived $ count must
    leave out."""
    C = setup["C"]
    assert int(C[6]) - int(C[5]) > 40


@pytest.mark.parametrize("k", range(1, 9))
def test_mirror_table_matches_plain_and_jax(setup, jax_tables, k):
    kinds = {}
    got = mirror_table(setup["fused"], setup["C"], k, kinds)
    plain = tfmd.build_jump_table_plain(setup["tdev"], k).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, jax_tables(k))
    if k >= 7:
        # deep levels hold absent parents and mostly one-row ones
        assert kinds["absent"] > 0 and kinds["one_row"] > kinds["two_rows"]


def edge_parents(setup, rng):
    """Parents whose lo and hi sit at offsets 0, 1, 63, 64 and 127, in one
    row and in two, with arbitrary x1, and absent parents (sz 0)."""
    n = setup["index"].n
    nblk = n // 128 + 1      # the rows that hold the index (the JAX
    #                          package pads the table past them)
    rows = []
    for a in EDGE_OFFSETS:
        for b in EDGE_OFFSETS:
            for gap in (0, 1, 3):
                if gap == 0 and b <= a:
                    continue
                for _ in range(3):
                    r = int(rng.integers(0, nblk - 1 - gap))
                    lo, hi = 128 * r + a, 128 * (r + gap) + b
                    if hi > n:
                        continue
                    rows.append((lo, int(rng.integers(0, n)), hi - lo, 0))
    for _ in range(20):
        rows.append((int(rng.integers(0, n)), int(rng.integers(0, n)), 0, 0))
    return np.array(rows, dtype=np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_level_edges(setup, seed):
    """A level over the edge parents equals the plain level step, and the
    parents reach every offset at both endpoints in one row and in two."""
    par = edge_parents(setup, np.random.default_rng(seed))
    kinds = {}
    got = mirror_level(setup["fused"], setup["C"], par, kinds)
    want = tfmd.jump_level_plain(setup["tdev"], torch.from_numpy(par))
    assert np.array_equal(got, want.numpy())
    assert kinds["absent"] == 20 and kinds["one_row"] and kinds["two_rows"]
    for name in ("lo", "hi"):
        for e in EDGE_OFFSETS:
            assert kinds[f"{name}_off{e}"] > 0, (name, e)


def test_planes_hold_every_code(setup):
    """The transpose: bit 4n + j of plane b is bit b of nibble n of packed
    word j of the group, for every row of the table."""
    fused = setup["fused"]
    rows = np.arange(fused.shape[0])
    b = load_planes(fused, rows)
    w = fused[:, 16:48].view(U32)
    for g in range(4):
        for j in range(4):
            for n in range(8):
                word = w[:, 4 * g + j + (16 if n >= 4 else 0)]
                code = (word >> U32(4 * (n % 4))) & U32(0xF)
                for bit in range(3):
                    got = (b[bit][:, g] >> U32(4 * n + j)) & U32(1)
                    assert np.array_equal(got, (code >> U32(bit)) & U32(1))


