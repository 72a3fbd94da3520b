"""The FM ping-pong search that kernel K2 runs a warp per lane
(svdss_tpu_torch/csrc/pingpong.cu), held on the CPU:

- a Python mirror of the kernel's lane, step by step in kernel order, with
  its 32-thread split of the rank step: thread t's packed word, its two
  masked popcounts packed in the halves of one word and summed over the
  warp (one reduction), the checkpoint by shuffle from threads 0-7, the
  row at hi loaded in step A of a wide interval so that step B loads
  nothing, the sentinel step's row-0 checkpoint, and the jump mode's key
  from k threads' symbols (one ballot, one OR-reduction);
- held against `batch_search_plain` and `svdss_tpu.ops.pingpong_jax
  .batch_search` in all six fields and the rank-step and jump-row counts:
  narrow, wide at limb widths 31 and 17, jump at k = 4 and 6, and the two
  pinned cases where the JAX package leaves the host oracle (C1: overlap
  0; C2: a padded k-mer key), where the mirror and the plain version
  follow the oracle;
- the reads of `chip_smoke.pingpong_edge_case`, which the card check also
  runs in all three modes: the mirror shows that they reach intervals
  ending exactly at the 256-symbol span and one past it, pending steps,
  sentinel steps, overflow at cap, both sides of the jump test safe_b's
  edge (and that safe_f holds wherever a lane turns), and wide ranks whose
  low limb carries past 2^limb_bits.

Integer results: equality is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svdss_tpu.index.fmd import build_index
from svdss_tpu.ops import fmd_jax
from svdss_tpu.ops.pingpong_jax import batch_search as jax_search
from svdss_tpu.utils.seq import kmer_keys
from svdss_tpu_torch.ops import fmd as tfmd
from svdss_tpu_torch.ops import pingpong
from svdss_tpu_torch.ops.pingpong import batch_search, pack_reads
from svdss_tpu_torch.ops.pingpong_host import ping_pong_search
from svdss_tpu_torch.utils.seq import encode_nt6
from test_torch_jump import setup  # noqa: F401 (a fixture)
from test_torch_pingpong import genome, read_mix, tables  # noqa: F401

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")
WARP, K_INNER, SPAN, CHUNK, STRIDE = 32, 48, 256, 256, 128
U32 = np.uint32
T = np.arange(WARP)

torch.set_num_threads(1)


# ------------------------------------------------------ the kernel's mirror

def nib_mask_lt(bound):
    """Each thread's nib_mask_lt(bound, t)."""
    k = bound >> 5
    if k >= 8:
        return np.full(WARP, 0x88888888, dtype=U32)
    full = ((1 << (4 * k)) - 1) & 0x88888888
    return np.where(T < (bound & 31), full | (8 << (4 * k)), full).astype(U32)


def nib_eq(words, c):
    x = words ^ U32(c * 0x11111111)
    return ~(x + U32(0x77777777)) & U32(0x88888888)


def popc(x):
    return np.bitwise_count(x).astype(U32)


def comp6(c):
    return 5 - c if 1 <= c <= 4 else c


class Table:
    """The kernel's view of a port table (on the CPU): the fused rows, C,
    and the limb width (None when narrow)."""

    def __init__(self, index):
        self.fused = index.fused.numpy()
        self.words = self.fused[:, 16:48].view(U32)
        self.C = [int(c) for c in index.C]
        self.limb = index.limb_bits

    def occ_from(self, ck, c):
        """occ_from: the shuffle of column c (and 6) from threads 0-7."""
        lo = int(ck[c])
        if self.limb is None:
            return lo
        return lo + ((((int(ck[6]) & 0xFFFFFFFF) >> (5 * c)) & 31)
                     << self.limb)


def window_key(P, kpos, k):
    """window_key: thread i < k loads P[kpos - i]; one ballot, one
    OR-reduction."""
    Lp1 = len(P)
    if kpos - (k - 1) < 0 or kpos >= Lp1:
        return -1
    s = [int(P[kpos - t]) if t < k else 1 for t in range(WARP)]
    bad = sum(1 << t for t in range(WARP) if not 1 <= s[t] <= 4)
    key = 0
    for t in range(k):
        key |= (s[t] - 1) << (2 * t)
    return -1 if bad else key


def run_lane(tab, P, length, cap, max_outer, overlap, jt, jump_k,
             n_windows, ev):
    """pingpong.cu's lane, every warp step written out; `ev` (a dict of
    counters and sets) gains what the lane reached."""
    C = tab.C
    Lp1 = len(P)
    active = length >= 1
    begin, end, dir_ = length - 1, 0, 0
    c0 = int(P[begin]) if active else 0
    pos, sz = C[c0], C[c0 + 1] - C[c0]
    pend, p_rank, p_hi = False, 0, 0
    count = blocks = rank_steps = jump_rows = 0
    overflow = False
    jumps = tab.limb is None and jump_k > 0
    base = 0
    out = []
    while active and blocks < max_outer:
        if jumps:
            cursor = min(max(begin if dir_ == 0 else end + 1, 0), Lp1 - 1)
            base = min(max((cursor - STRIDE // 2) >> 7, 0),
                       n_windows - 1) * STRIDE
        k = 0
        while k < K_INNER and active:
            k += 1
            is_bwd = dir_ == 0
            bwd_can = is_bwd and sz != 0 and begin > 0
            fwd_can = not is_bwd and sz != 0
            do_ext = bwd_can or fwd_can
            if is_bwd:
                a = begin - 1 if bwd_can else begin
            else:
                a = end + 1 if fwd_can else end - 1
            a = max(a, 0)
            # the rows, issued with P[a]; step B loads nothing
            lo = pos if do_ext else 0
            szm = sz if do_ext else 0
            off_lo = lo & 127
            off_hi = off_lo + szm
            hi = lo + szm
            near = off_hi <= SPAN
            if not pend:
                w_lo, ck_lo = tab.words[lo >> 7], tab.fused[lo >> 7, :8]
                if not near:
                    w_hi, ck_hi = tab.words[hi >> 7], tab.fused[hi >> 7, :8]
            c_acc = int(P[a]) if a < Lp1 else 0
            c_sel = c_acc if is_bwd else comp6(c_acc)
            sent = not is_bwd and c_acc == 0
            do_rank = do_ext and not sent
            rank_steps += do_rank
            if pend:
                complete = True
                rank_lo, szn = p_rank, p_hi - p_rank
                pend = False
                ev["step_b"] += 1
            elif do_rank:
                zm = nib_eq(w_lo, c_sel)
                below_lo = nib_mask_lt(off_lo)
                n_lo = popc(zm & below_lo)
                if near:
                    n_hi = popc(zm & nib_mask_lt(off_hi) & ~below_lo)
                else:
                    n_hi = popc(nib_eq(w_hi, c_sel) & nib_mask_lt(hi & 127))
                assert n_lo.max() <= 8 and n_hi.max() <= 8
                s = int(np.sum(n_lo | (n_hi << U32(16)), dtype=np.uint64))
                assert s < 1 << 32 and (s & 0xFFFF) <= 128 and s >> 16 <= 256
                anchor = tab.occ_from(ck_lo, c_sel) + (s & 0xFFFF)
                rank_lo = anchor
                if tab.limb is not None and \
                        int(ck_lo[c_sel]) + (s & 0xFFFF) >= 1 << tab.limb:
                    ev["limb_carry"] += 1
                if near:
                    complete = True
                    szn = s >> 16
                    ev["span_end"] += off_hi == SPAN
                else:
                    complete = False
                    szn = 0
                    pend = True
                    p_rank = anchor
                    p_hi = tab.occ_from(ck_hi, c_sel) + (s >> 16)
                    if tab.limb is not None and \
                            int(ck_hi[c_sel]) + (s >> 16) >= 1 << tab.limb:
                        ev["limb_carry"] += 1
                    ev["step_a"] += 1
                    ev["span_past"] += off_hi == SPAN + 1
            else:
                complete = True
                szn = 0
                rank_lo = tab.occ_from(tab.fused[0, :8], 0) if sent else 0
                ev["sentinel"] += sent
            posn = C[c_sel] + rank_lo

            upd_b = bwd_can and complete
            upd_f = fwd_can and complete
            b_exit = is_bwd and not bwd_can
            f_exit = not is_bwd and not fwd_can
            begin1 = begin - 1 if upd_b else begin
            end1 = end + 1 if upd_f else end
            sz1 = sz
            if do_ext and complete:
                pos, sz1 = posn, szn
            prefix_match = b_exit and begin == 0 and sz != 0
            to_fwd = b_exit and not prefix_match
            if f_exit:
                if count < cap:
                    out.append((begin1, end1 - begin1 + 1))
                count += 1
            emit_done = f_exit and begin1 == 0
            restart = f_exit and not emit_done
            if to_fwd:
                dir_ = 1
                end1 = begin1
                pos = C[comp6(c_acc)]
                sz1 = C[c_acc + 1] - C[c_acc]
                kpos = begin1 + jump_k - 1
                if jumps:
                    ev["koff_f"].add(kpos - base)
                    ev["koff_f_end"].add(kpos - base + K_INNER + 1 - CHUNK)
                key = (window_key(P, kpos, jump_k)
                       if jumps and kpos - base >= 0
                       and kpos - base + K_INNER + 1 < CHUNK else -1)
                if key >= 0:
                    jump_rows += 1
                    r = jt[key]
                    if r[2] > 0:
                        pos, sz1, end1 = int(r[1]), int(r[2]), kpos
            elif restart:
                dir_ = 0
                begin_new = begin1 - 1 if overlap == 0 else end1 + overlap
                begin1 = begin_new
                cr = int(P[begin1]) if 0 <= begin1 < Lp1 else 0
                pos, sz1 = C[cr], C[cr + 1] - C[cr]
                koff = begin_new - base
                if jumps:
                    ev["begin_new"].add(begin_new - (jump_k - 1))
                    if begin_new >= jump_k - 1:
                        ev["koff_b"].add(koff - (jump_k + K_INNER))
                key = (window_key(P, begin_new, jump_k)
                       if jumps and begin_new >= jump_k - 1
                       and jump_k + K_INNER <= koff < CHUNK else -1)
                if key >= 0:
                    jump_rows += 1
                    r = jt[key]
                    if r[2] > 0:
                        pos, sz1 = int(r[0]), int(r[2])
                        begin1 = begin_new - (jump_k - 1)
            if prefix_match or emit_done:
                active = False
            begin, end, sz = begin1, end1, sz1
        blocks += 1
        if count > cap:
            overflow = True
            active = False
    ev["overflow"] += overflow
    return out, count, overflow, active, blocks, rank_steps, jump_rows


def new_events():
    return dict(step_a=0, step_b=0, sentinel=0, span_end=0, span_past=0,
                limb_carry=0, overflow=0, koff_f=set(), koff_f_end=set(),
                koff_b=set(), begin_new=set())


def mirror_search(index, seqs, lens, cap, max_iters=0, overlap=-1,
                  jump_table=None, jump_k=0, ev=None):
    """The kernel over every lane: the six fields (numpy) and the rank
    steps and jump rows, as batch_search's `work` counts them."""
    tab = Table(index)
    seqs, lens = seqs.numpy(), lens.numpy()
    Q, Lp1 = seqs.shape
    max_iters = max_iters or 8 * (Lp1 - 1) + 64
    max_outer = -(-max_iters // K_INNER)
    jt = None if jump_table is None else jump_table.numpy()
    ev = new_events() if ev is None else ev
    res = dict(qs=np.zeros((Q, cap), np.int32),
               length=np.zeros((Q, cap), np.int32),
               n_sfs=np.zeros(Q, np.int32), overflow=np.zeros(Q, bool),
               incomplete=np.zeros(Q, bool))
    iters = steps = rows = 0
    for q in range(Q):
        out, count, ovf, act, blocks, rs, jr = run_lane(
            tab, seqs[q], int(lens[q]), cap, max_outer, overlap, jt, jump_k,
            pingpong.n_windows(Lp1), ev)
        for i, (qs, ln) in enumerate(out):
            res["qs"][q, i], res["length"][q, i] = qs, ln
        res["n_sfs"][q] = min(count, cap)
        res["overflow"][q], res["incomplete"][q] = ovf, act
        iters = max(iters, blocks * K_INNER)
        steps += rs
        rows += jr
    res["iters"] = np.int32(iters)
    return res, steps, rows


def plain(index, seqs, lens, **kw):
    """The port's batch_search on the CPU (the plain version) with its
    work counters."""
    work = torch.zeros(2, dtype=torch.int64)
    got = batch_search(index, seqs, lens, work=work, **kw)
    return {f: getattr(got, f).numpy() for f in FIELDS}, work.tolist()


def assert_same(a, b, lanes=slice(None)):
    for f in FIELDS:
        x, y = np.asarray(a[f]), np.asarray(b[f])
        if f != "iters":
            x, y = x[lanes], y[lanes]
        assert x.shape == y.shape and np.array_equal(x, y), f


def jax_fields(res):
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def held(index, seqs, lens, ev=None, **kw):
    """Mirror against the plain version, fields and counts; returns the
    mirror's fields."""
    got, steps, rows = mirror_search(index, seqs, lens, ev=ev, **kw)
    want, (w_steps, w_rows) = plain(index, seqs, lens, **kw)
    assert_same(got, want)
    assert (steps, rows) == (w_steps, w_rows)
    return got


def lane(res, i):
    n = int(res["n_sfs"][i])
    return list(zip(res["qs"][i, :n].tolist(), res["length"][i, :n].tolist()))


# ------------------------------------------------------------ narrow, C1

@pytest.mark.parametrize("kw", [dict(cap=256), dict(cap=2),
                                dict(cap=8, max_iters=200)],
                         ids=["full", "cap2", "max_iters200"])
def test_narrow_mirror_matches_plain_and_jax(genome, tables, kw):
    encoded = read_mix(genome, np.random.default_rng(1234))
    seqs, lens = pack_reads(encoded, device="cpu")
    got = held(tables[2], seqs, lens, **kw)
    want = jax_search(tables[1], jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), **kw)
    assert_same(got, jax_fields(want))


def test_overlap0_c1_follows_oracle(genome, tables):
    """Pin C1: with overlap 0 the mirror and the plain version re-seed a
    restart from P[begin_new] and give the host oracle's list on read 7 of
    the seed-1234 mix; the JAX package re-seeds from P[end - 1] and emits
    an extra SFS there."""
    encoded = read_mix(genome, np.random.default_rng(1234))
    seqs, lens = pack_reads(encoded, device="cpu")
    got = held(tables[2], seqs, lens, cap=256, overlap=0)
    oracle = [ping_pong_search(tables[0], e, 0) for e in encoded]
    assert [lane(got, i) for i in range(len(encoded))] == oracle
    assert oracle[7] == [(104, 7), (50, 1)]
    want = jax_fields(jax_search(
        tables[1], jnp.asarray(seqs.numpy()), jnp.asarray(lens.numpy()),
        cap=256, overlap=0))
    assert lane(want, 7) == [(104, 7), (98, 8), (50, 1)]


# ------------------------------------------------------------------- wide

@pytest.fixture(scope="module")
def wide_genome():
    """300 kb: each symbol's count (~150k on two strands) passes 2^17, so
    the limb-17 table's high limbs are not 0."""
    rng = np.random.default_rng(171)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 300_000))
    reads = read_mix({"g1": g[:20_000]}, np.random.default_rng(17))[:14]
    return build_index({"w": g}), reads


@pytest.fixture(params=[31, 17])
def limb(request, monkeypatch):
    """The limb width, on the JAX side too (its functions read the module
    global at trace time, so jit caches are dropped around it)."""
    monkeypatch.setattr(fmd_jax, "LIMB_BITS", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def test_wide_mirror_matches_plain_and_jax(wide_genome, limb):
    index, reads = wide_genome
    tdev = tfmd.DeviceFMDIndex.from_host(index, device="cpu",
                                         force_wide=True, limb_bits=limb)
    assert bool((tdev.fused[:, 6] != 0).any()) == (limb < 31)
    seqs, lens = pack_reads(reads, device="cpu")
    ev = new_events()
    got = held(tdev, seqs, lens, ev=ev, cap=256)
    jdev = fmd_jax.DeviceFMDIndex.from_host(index, force_wide=True)
    want = jax_search(jdev, jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), cap=256)
    assert_same(got, jax_fields(want))
    narrow, _ = plain(tfmd.DeviceFMDIndex.from_host(index, device="cpu"),
                      seqs, lens, cap=256)
    assert_same(got, narrow)
    assert ev["step_a"] > 0 and ev["step_b"] == ev["step_a"]


# ------------------------------------------------------------- jump, C2

def both_jump(setup, encoded, k, **kw):
    """The mirror (held against the plain version) and the JAX package's
    jump search on the same packed reads."""
    seqs, lens = pack_reads(encoded, device="cpu")
    jt = torch.from_numpy(np.asarray(fmd_jax.build_jump_table(
        setup["jdev"], k, chunk=1 << 12)).copy())
    got = held(setup["tdev"], seqs, lens, jump_table=jt, jump_k=k, **kw)
    want = jax_search(setup["jdev"], jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), jump_table=jnp.asarray(
                          jt.numpy()), keys=jnp.asarray(
                          kmer_keys(seqs.numpy(), k)), jump_k=k, **kw)
    return got, jax_fields(want)


@pytest.mark.parametrize("k,kw", [(4, dict(cap=256)), (6, dict(cap=256)),
                                  (6, dict(cap=2)),
                                  (6, dict(cap=256, max_iters=200))],
                         ids=["k4", "k6", "k6-cap2", "k6-max_iters200"])
def test_jump_mirror_matches_plain_and_jax(setup, k, kw):
    got, want = both_jump(setup, setup["encoded"], k, **kw)
    assert_same(got, want)


@pytest.mark.parametrize("k", [4, 6])
def test_padded_key_c2_follows_oracle(setup, k):
    """Pin C2: a read as long as the batch ending in N turns forward on the
    window that ends past the padded read. The JAX package's key chunks
    hold 0 there (poly-A's key) and its lane setup and leaves the host
    oracle; the mirror and the plain version hold no key there and follow
    the oracle. Every other lane equals the JAX package's."""
    enc = setup["encoded"]
    L = max(len(e) for e in enc)
    assert L == 488
    g = setup["genome"]["a"]
    enc = enc + [encode_nt6(g[2000:2000 + L - 1] + "N")]
    got, want = both_jump(setup, enc, k, cap=256)
    oracle = ping_pong_search(setup["index"], enc[-1])
    assert lane(got, len(enc) - 1) == oracle != lane(want, len(enc) - 1)
    assert_same({f: got[f] for f in FIELDS if f != "iters"} | {"iters": 0},
                {f: want[f] for f in FIELDS if f != "iters"} | {"iters": 0},
                lanes=slice(0, -1))


# ------------------------------------------------------------- edge reads

EDGE_MODES = ("narrow", "wide12", "wide31", "jump4", "jump6")


@pytest.fixture(scope="module")
def edge_runs():
    """`chip_smoke.pingpong_edge_case` in every mode, mirror against the
    plain version (cap 64, so some lanes overflow): {mode: (fields,
    events)}."""
    g, reads = chip_smoke.pingpong_edge_case()
    index = build_index({"e": g})
    seqs, lens = pack_reads(reads, device="cpu")
    narrow = tfmd.DeviceFMDIndex.from_host(index, device="cpu")
    runs = {}
    for mode in EDGE_MODES:
        kw = dict(cap=64)
        tab = narrow
        if mode.startswith("wide"):
            tab = tfmd.DeviceFMDIndex.from_host(
                index, device="cpu", force_wide=True,
                limb_bits=int(mode[4:]))
        elif mode.startswith("jump"):
            k = int(mode[4:])
            kw.update(jump_table=tfmd.build_jump_table(narrow, k), jump_k=k)
        ev = new_events()
        runs[mode] = held(tab, seqs, lens, ev=ev, **kw), ev
    return runs


@pytest.mark.parametrize("mode", EDGE_MODES)
def test_edge_reads_mirror_matches_plain(edge_runs, mode):
    """The mirror equals the plain version on the edge reads (asserted
    while the runs are made), and every mode gives the narrow search's
    fields; the jump modes' complete lanes give its SFS lists."""
    got, _ = edge_runs[mode]
    base, _ = edge_runs["narrow"]
    if mode.startswith("jump"):
        done = ~(got["overflow"] | got["incomplete"] | base["overflow"]
                 | base["incomplete"])
        assert done.sum() > len(done) // 2
        for i in np.flatnonzero(done):
            assert lane(got, i) == lane(base, i), i
        assert int(got["iters"]) <= int(base["iters"])
    else:
        assert_same(got, base)


def test_edge_reads_match_jax(edge_runs):
    """The narrow search of the edge reads equals the JAX package's."""
    g, reads = chip_smoke.pingpong_edge_case()
    jdev = fmd_jax.DeviceFMDIndex.from_host(build_index({"e": g}))
    seqs, lens = pack_reads(reads, device="cpu")
    want = jax_search(jdev, jnp.asarray(seqs.numpy()),
                      jnp.asarray(lens.numpy()), cap=64)
    assert_same(edge_runs["narrow"][0], jax_fields(want))


def test_edge_reads_reach_every_edge(edge_runs):
    """What the edge reads reach in the kernel's steps: ranks whose
    interval ends exactly at the 256-symbol span and one past it (step A
    and its pending step B), sentinel steps, overflow at cap, low limbs
    that carry past 2^12, and both sides of safe_b's edge (koff = k + 48
    may jump, k + 47 may not). safe_b's other tests and safe_f are out of
    reach, and the mirror shows that they hold: begin_new >= koff, so
    begin_new >= k - 1 follows from koff >= k + 48; koff < 256 and
    safe_f's koff in [0, 206] hold because a lane's transitions stay
    within a block's drift of its cursor, which lies in [64, 192) of its
    chunk or in a chunk at base 0. The kernel keeps these tests for the
    JAX package's geometry."""
    for mode in EDGE_MODES:
        ev = edge_runs[mode][1]
        assert ev["span_end"] > 0 and ev["span_past"] > 0, mode
        assert ev["step_a"] > 0 and ev["step_b"] >= ev["step_a"] - 9, mode
        assert ev["sentinel"] > 0 and ev["overflow"] > 0, mode
    assert edge_runs["wide12"][1]["limb_carry"] > 0
    assert edge_runs["wide31"][1]["limb_carry"] == 0
    for k in (4, 6):
        ev = edge_runs[f"jump{k}"][1]
        assert {-1, 0} <= ev["koff_b"], k
        assert max(ev["koff_b"]) < CHUNK - (k + K_INNER), k
        assert min(ev["begin_new"]) >= 0, k
        assert min(ev["koff_f"]) >= 0 and max(ev["koff_f_end"]) < 0, k
