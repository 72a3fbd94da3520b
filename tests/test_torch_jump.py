"""The port's k-mer jump-start path against the JAX package's, on the CPU:
the bi-interval extension `extend_select`, the jump table (kernel K6's
plain version), the FM search's jump mode (kernel K2's plain version), and
the search stage's table gate and output. Inputs come from numpy seeds;
every value is an integer, so equality is exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdss_tpu.config import Config as JConfig
from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops import fmd_jax
from svdss_tpu.ops.pingpong_jax import batch_search as jax_search
from svdss_tpu.pipeline import search as j_search
from svdss_tpu.utils.seq import kmer_keys
from svdss_tpu_torch.config import Config
from svdss_tpu_torch.ops import fmd as tfmd
from svdss_tpu_torch.ops.pingpong import batch_search, pack_reads
from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
from svdss_tpu_torch.pipeline import search
from svdss_tpu_torch.utils.seq import encode_nt6, revcomp_str

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")

# the lockstep plain versions gain little from threads, and the suite runs
# several test processes side by side
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """The genome and read mix of tests/test_kmer_jump.py (seed 2024), with
    both packages' device tables over one fused table."""
    rng = np.random.default_rng(2024)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = {"a": bases[rng.integers(0, 4, 6000)].tobytes().decode(),
              "b": bases[rng.integers(0, 4, 2500)].tobytes().decode()}
    index = build_index(genome)
    jdev = fmd_jax.DeviceFMDIndex.from_host(index)
    tdev = tfmd.DeviceFMDIndex.from_arrays(np.asarray(jdev.fused),
                                           np.asarray(jdev.C), device="cpu")
    g = genome["a"]
    reads = []
    for trial in range(20):
        ln = int(rng.integers(140, 500))
        p = int(rng.integers(0, len(g) - ln))
        read = list(g[p:p + ln])
        for _ in range(int(rng.integers(0, 8))):
            read[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        read = "".join(read)
        if trial % 3 == 0:
            read = revcomp_str(read)
        if trial % 5 == 0:
            read = read[:70] + "N" + read[70:]
        reads.append(read)
    ins = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    reads.append(g[30:230] + ins + g[230:420])
    reads.append("".join("ACGT"[i] for i in rng.integers(0, 4, 250)))
    mut_start = list(g[1000:1200])
    mut_start[2] = "ACGT"[("ACGT".index(mut_start[2]) + 1) % 4]
    reads.append("".join(mut_start))
    return dict(genome=genome, index=index, jdev=jdev, tdev=tdev,
                encoded=[encode_nt6(r) for r in reads])


@pytest.fixture(scope="module")
def jt(setup):
    """The JAX package's jump table of the setup genome at k (small
    chunks, as tests/test_kmer_jump.py builds it), built once per k."""
    cache = {}

    def table(k):
        if k not in cache:
            cache[k] = np.asarray(fmd_jax.build_jump_table(
                setup["jdev"], k, chunk=1 << 12))
        return torch.from_numpy(cache[k].copy())
    return table


@pytest.fixture(scope="module")
def nojump(setup):
    """The port's search of the read mix without jumps (cap 256), and the
    rank steps it took."""
    seqs, lens = pack_reads(setup["encoded"], device="cpu")
    work = torch.zeros(1, dtype=torch.int64)
    return batch_search(setup["tdev"], seqs, lens, cap=256, work=work), \
        int(work)


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_select_matches_jax(setup, seed):
    """Random bi-intervals, both directions, every symbol, a third of the
    lanes masked (do False: a 0-width query at position 0)."""
    rng = np.random.default_rng(seed)
    n = setup["index"].n
    Q = 4096
    sz = rng.integers(0, 600, Q).astype(np.int32)
    x0 = rng.integers(0, n - sz + 1).astype(np.int32)
    x1 = rng.integers(0, n - sz + 1).astype(np.int32)
    is_back = rng.random(Q) < 0.5
    c = rng.integers(0, 6, Q).astype(np.int32)
    do = rng.random(Q) < 0.67
    want = fmd_jax.extend_select(setup["jdev"], *(jnp.asarray(a) for a in (
        x0, x1, sz, is_back, c, do)))
    got = tfmd.extend_select(setup["tdev"], *(torch.from_numpy(a) for a in (
        x0, x1, sz, is_back, c, do)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(),
                                                         np.asarray(w))


@pytest.mark.parametrize("k", [1, 6, 8])
def test_jump_table_matches_jax(setup, jt, k):
    """Every column of every row, absent k-mers included (sz 0, with the
    columns the JAX package's masked lanes give them)."""
    got = tfmd.build_jump_table(setup["tdev"], k)
    want = jt(k).numpy()
    assert got.dtype == torch.int32 and got.shape == (4 ** k, 4)
    assert np.array_equal(got.numpy(), want)
    if k == 8:
        assert (want[:, 2] == 0).any() and (want[:, 2] > 0).any()


def test_jump_level_plain_chunks(setup, jt):
    """The plain level step gives the same rows in any parent chunking."""
    rows = jt(5)
    whole = tfmd.jump_level_plain(setup["tdev"], rows)
    assert torch.equal(whole, jt(6))
    assert torch.equal(tfmd.jump_level_plain(setup["tdev"], rows, chunk=77),
                       whole)


def lanes(res, i):
    n = int(res.n_sfs[i])
    return list(zip(res.qs[i, :n].tolist(), res.length[i, :n].tolist()))


def both(setup, jt, encoded, k, **kw):
    """The port's batch_search with jumps and the JAX package's, on the
    same packed reads."""
    seqs, lens = pack_reads(encoded, device="cpu")
    got = batch_search(setup["tdev"], seqs, lens, jump_table=jt(k),
                       jump_k=k, **kw)
    keys = kmer_keys(seqs.numpy(), k)
    want = jax_search(setup["jdev"], jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), jump_table=jnp.asarray(
                          jt(k).numpy()), keys=jnp.asarray(keys), jump_k=k,
                      **kw)
    return got, want


@pytest.mark.parametrize("k,kw", [(6, dict(cap=256)), (4, dict(cap=256)),
                                  (6, dict(cap=2)),
                                  (6, dict(cap=256, max_iters=200))],
                         ids=["k6", "k4", "k6-cap2", "k6-max_iters200"])
def test_batch_search_jump_matches_jax(setup, jt, nojump, k, kw):
    """All six fields equal the JAX package's jump search; complete lanes
    equal the search without jumps and the host oracle, in fewer steps."""
    enc = setup["encoded"]
    got, want = both(setup, jt, enc, k, **kw)
    if kw == dict(cap=256):
        plain = nojump[0]
    else:
        seqs, lens = pack_reads(enc, device="cpu")
        plain = batch_search(setup["tdev"], seqs, lens, **kw)
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.array_equal(g, w), f
    assert int(got.iters) <= int(plain.iters)
    done = ~(got.overflow | got.incomplete | plain.overflow
             | plain.incomplete)
    for i in np.nonzero(done.numpy())[0]:
        assert lanes(got, i) == lanes(plain, i) \
            == ping_pong_search(setup["index"], enc[i]), i
    if kw == dict(cap=256):
        assert bool(done.all()) and int(got.iters) < int(plain.iters)
    else:
        assert bool((got.overflow | got.incomplete).any())


def test_work_counts_fewer_rank_steps(setup, jt, nojump):
    """The work counter keeps counting rank steps in jump mode, and a
    second counter the jump-table rows read."""
    seqs, lens = pack_reads(setup["encoded"], device="cpu")
    with_j = torch.zeros(2, dtype=torch.int64)
    batch_search(setup["tdev"], seqs, lens, cap=256, work=with_j,
                 jump_table=jt(6), jump_k=6)
    steps, rows = with_j.tolist()
    assert 0 < steps < nojump[1] and rows > 0


@pytest.mark.parametrize("k", [4, 6])
def test_padded_key_follows_oracle(setup, jt, k):
    """A read as long as the batch ending in N (absent from the index)
    turns forward at once, on the k-mer window that ends k - 2 past the
    padded read. The JAX package's key chunks hold 0 there (the key of
    poly-A, present in this genome) and the lane jumps and leaves the host
    oracle; the port holds no key there and follows the oracle. Every
    other lane equals the JAX package's."""
    assert int(jt(k)[0, 2]) > 0
    enc = setup["encoded"]
    L = max(len(e) for e in enc)
    g = setup["genome"]["a"]
    enc = enc + [encode_nt6(g[2000:2000 + L - 1] + "N")]
    got, want = both(setup, jt, enc, k, cap=256)
    oracle = ping_pong_search(setup["index"], enc[-1])
    n = int(want.n_sfs[-1])
    jax_lane = list(zip(np.asarray(want.qs[-1, :n]).tolist(),
                        np.asarray(want.length[-1, :n]).tolist()))
    assert lanes(got, len(enc) - 1) == oracle
    assert jax_lane != oracle
    for f in ("qs", "length", "n_sfs", "overflow", "incomplete"):
        g_, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.array_equal(g_[:-1], w[:-1]), f


def test_wide_table_raises(setup):
    wide = tfmd.DeviceFMDIndex.from_host(setup["index"], "cpu",
                                         force_wide=True)
    with pytest.raises(ValueError):
        tfmd.build_jump_table(wide, 4)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tfmd.extend_select(wide, z, z, z, z > 0, z, z > 0)
    with pytest.raises(ValueError):
        tfmd.build_jump_table(setup["tdev"], 16)


# ------------------------------------------------------------ search stage

class BigN:
    """An index whose symbol count reads as `n` (the gates look only at
    that); everything else is the real index's."""

    def __init__(self, index, n):
        self._index = index
        self.n = n

    def __getattr__(self, name):
        return getattr(self._index, name)


@pytest.fixture
def real_tables(monkeypatch):
    """Both packages build their device tables, and the JAX package its
    jump table (in small chunks), from the real index behind a BigN."""
    jfrom = fmd_jax.DeviceFMDIndex.from_host
    tfrom = tfmd.DeviceFMDIndex.from_host
    monkeypatch.setattr(fmd_jax.DeviceFMDIndex, "from_host", classmethod(
        lambda cls, idx, *a, **kw: jfrom(getattr(idx, "_index", idx),
                                         *a, **kw)))
    monkeypatch.setattr(search.DeviceFMDIndex, "from_host", classmethod(
        lambda cls, idx, *a, **kw: tfrom(getattr(idx, "_index", idx),
                                         *a, **kw)))
    monkeypatch.setattr(fmd_jax, "build_jump_table", functools.partial(
        fmd_jax.build_jump_table, chunk=1 << 10))


@pytest.fixture(scope="module")
def anchors(setup):
    from svdss_tpu.index.fmd import genome_text as j_genome_text
    from svdss_tpu.ops.anchor import build_anchor_index as j_build
    from svdss_tpu_torch.index.fmd import genome_text
    from svdss_tpu_torch.ops.anchor import build_anchor_index
    return (build_anchor_index(genome_text(setup["genome"])),
            j_build(j_genome_text(setup["genome"])))


# (engine, index symbols, anchor tables given, expected engine, table)
GATE = [
    ("fm", None, False, "fm", False),
    ("fm", 1 << 22, False, "fm", True),
    ("auto", 1 << 22, True, "fm", True),
    ("auto", 1 << 26, True, "anchor", False),
    ("anchor", None, True, "anchor", False),
    ("fm", 1 << 26, True, "fm", True),
]


@pytest.mark.parametrize("engine,n,with_anchor,expected,table", GATE)
def test_gate_matches_jax(setup, anchors, real_tables, engine, n,
                          with_anchor, expected, table, caplog):
    """kmer_jump = 5: the FM engine builds the table from 2^22 symbols, as
    the JAX package does, with the same rows; the anchor engine ignores
    kmer_jump."""
    index, jindex = setup["index"], setup["index"]
    if n:
        index, jindex = BigN(index, n), BigN(jindex, n)
    anchor, janchor = anchors if with_anchor else (None, None)
    caplog.set_level("INFO", logger="svdss_tpu")
    mine = search._DeviceSearcher(index, Config(engine=engine, kmer_jump=5),
                                  "cpu", anchor)
    theirs = j_search._DeviceSearcher(jindex, JConfig(engine=engine,
                                                      kmer_jump=5), janchor)
    for s in (mine, theirs):
        assert ("fm" if s.anchor is None else "anchor") == expected
        assert (s.jump_table is not None) == table
        assert s.jump_k == (5 if table else 0)
    if table:
        assert np.array_equal(mine.jump_table.numpy(),
                              np.asarray(theirs.jump_table))
    built = [r.getMessage() for r in caplog.records
             if "5-mer jump table" in r.getMessage()]
    assert len(built) == (2 if table else 0)


def test_run_search_jump_matches_jax_and_host(setup, real_tables,
                                              tmp_path, caplog):
    """run_search with kmer_jump on an index the gate takes for 2^22
    symbols: the port searches with its table (kernel K2's jump mode, plain
    version) and gives the JAX package's output and the host engines'."""
    fq = tmp_path / "reads.fq"
    rng = np.random.default_rng(9)
    g = setup["genome"]["b"]
    with open(fq, "w") as fh:
        for k, enc in enumerate(setup["encoded"]):
            s = "".join("$ACGTN"[c] for c in enc)
            fh.write(f"@m{k}\n{s}\n+\n{'I' * len(s)}\n")
        for k in range(6):
            p = int(rng.integers(0, len(g) - 700))
            s = g[p:p + 700]
            fh.write(f"@b{k}\n{revcomp_str(s) if k % 2 else s}\n+\n"
                     f"{'I' * len(s)}\n")
    cfg = dict(use_device=True, engine="fm", kmer_jump=6, lanes=16)
    caplog.set_level("INFO", logger="svdss_tpu")
    big = 1 << 22
    got = search.run_search(Config(**cfg), BigN(setup["index"], big),
                            fastx=str(fq), device="cpu")
    assert any("built 6-mer jump table" in r.getMessage()
               for r in caplog.records)
    want = j_search.run_search(JConfig(**cfg), BigN(setup["index"], big),
                               fastx=str(fq))
    host = search.run_search(Config(use_device=False), setup["index"],
                             fastx=str(fq))

    def norm(groups):
        return [(q, [(s.qs, s.l, s.htag) for s in gr]) for q, gr in groups]
    assert norm(got) == norm(want) == norm(host)
    assert sum(len(gr) for _, gr in got) > 0
