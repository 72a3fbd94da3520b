"""The anchor lane machine that kernels K3 and K4 run a warp per read
(svdss_tpu_torch/csrc/anchor.cu), held on the CPU:

- a scalar Python mirror of the kernel's round, with its 32-thread split
  of the key (one ballot, one OR-reduction) and of the compare (four
  symbols a thread from two text words, one min-reduction), against the
  plain version `batch_search_anchor_plain` and the pool's plain path, in
  all result fields and the four work counts;
- the reads of `chip_smoke.lane_edge_case`, which the card check also
  runs: the mirror shows that they reach each edge of the key and compare
  steps, and the plain version equals `anchor_jax.batch_search_anchor` on
  them;
- the port's AnchorPool under chunks of 2, 14 and 128 reads against the
  JAX package's pool and one-shot search.

Integer results: equality is exact."""

import numpy as np
import pytest
import torch

import chip_smoke
from svdss_tpu.index.fmd import genome_text as j_genome_text
from svdss_tpu.ops import anchor_jax
from svdss_tpu.ops.anchor import build_anchor_index as j_build_anchor_index
from svdss_tpu.ops.anchor_pool import AnchorPool as JaxPool
from svdss_tpu.ops.pingpong_jax import pack_reads as j_pack_reads
from svdss_tpu_torch.ops.anchor_device import (WORK_FIELDS,
                                               batch_search_anchor_plain,
                                               default_max_rounds,
                                               from_arrays)
from svdss_tpu_torch.ops.anchor_pool import (AnchorPool, pack_chunk,
                                             pool_search_plain)
from test_torch_anchor_pool import make_reads, one_shot, run_port

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")
WARP, PER_THREAD, SPAN, STAGE_EVERY = 32, 4, 128, 8
KEY, SUB, POS, VER = 0, 1, 2, 3


# ------------------------------------------------------ the kernel's mirror

class Tables:
    """The kernel's `Tables` from the port's device tables (on the CPU)."""

    def __init__(self, dev, params):
        self.small = dev.small.numpy().astype(np.int64)
        self.words = dev.text_words.numpy().view(np.uint32).reshape(-1)
        self.n, self.k, self.j0 = params.n, params.k, params.j0
        self.cmax, self.pos_base = params.cmax, params.pos_base
        self.nrow = params.n // 64 + 1
        self.bm = [0] * 16
        self.bm[params.j0 + 1:params.k] = params.bm_bases


def read_sym(P, plen, side, w8, y):
    if side == 0:
        return int(P[y]) if 0 <= y < plen else 0
    j = w8 - 1 - y
    if 0 <= j < plen:
        c = int(P[j])
        return 5 - c if 1 <= c <= 4 else c
    return 0


def text_syms(T, p):
    """A thread's four text symbols at p.. from the two words that hold
    them (anchor.cu text_syms)."""
    pa, pb = min(max(p, 0), T.n - 1), min(max(p + PER_THREAD - 1, 0),
                                          T.n - 1)
    wa, wb = (int(T.words[(q >> 6) * 16 + ((q & 63) >> 3)])
              for q in (pa, pb))
    out = []
    for i in range(PER_THREAD):
        q = p + i
        w = wa if q >> 3 == pa >> 3 else wb
        out.append((w >> (4 * (q & 7))) & 0xF if 0 <= q < T.n else 0)
    return out


def quad(a, b, c, d, sel):
    return (d if sel & 1 else c) if sel & 2 else (b if sel & 1 else a)


def run_lane(T, P, plen, length, nwm, cap, max_rounds, budget, overlap,
             events):
    """anchor.cu run_lane, every warp step written out over its 32
    threads; `events` gets one dict per round."""
    k, j0 = T.k, T.j0
    w8 = 64 * (nwm + 1)
    active, fb, overflow = length >= 1, False, False
    dirb, mode, anc = 1, KEY, length - 1
    key = subj = cnt = aux = occ_i = 0
    prow = -1
    p0 = p1 = p2 = p3 = occ1c = occ_pos = ext = best = count = r = 0
    out = []
    work = [0, 0, 0, 0]
    while active and not fb and r < max_rounds:
        blk_end = r + STAGE_EVERY
        while active and not fb and r < max_rounds and r < blk_end:
            r += 1
            work[0] += 1
            ev = {"mode": mode, "dirb": dirb}
            is_b = dirb == 1
            u = length - 1 - anc if is_b else anc
            maxlen = anc + 1 if is_b else length - anc
            mk = min(k, maxlen)
            is_key, is_sub = mode == KEY, mode == SUB
            is_pos, is_ver = mode == POS, mode == VER
            rstart = u + k + ext if is_ver else u
            if is_b:
                rstart += w8 - length
            m_r = min(max(rstart >> 6, 0), nwm - 1)
            col_a = rstart - (m_r << 6)
            ybase = m_r << 6
            cmp_off = col_a if is_ver else col_a + k
            ev.update(m_r=m_r, col_a=col_a)
            rs = [[0] * PER_THREAD for _ in range(WARP)]
            if not is_sub:
                for t in range(WARP):
                    y = ybase + cmp_off + PER_THREAD * t
                    rs[t] = [read_sym(P, plen, dirb, w8, y + i)
                             for i in range(PER_THREAD)]
            key_new = 0
            clean = floor_case = use_meta = to_sub_short = fb_new = False
            if is_key:
                validm = 0
                for t in range(k):      # the ballot and the OR-reduction
                    c = col_a + t
                    sym = (read_sym(P, plen, dirb, w8, ybase + c)
                           if 0 <= c < SPAN else 0)
                    if 1 <= sym <= 4:
                        validm |= 1 << t
                    key_new |= min(max(sym - 1, 0), 3) << (2 * (k - 1 - t))
                need = (1 << min(max(mk, 0), 30)) - 1
                clean = (validm & need) == need
                floor_case = maxlen <= j0
                fb_new = not clean
                use_meta = clean and maxlen >= k
                to_sub_short = clean and j0 < maxlen < k
                ev.update(key_dirty=not clean)
            key_j = key >> (2 * (k - min(max(subj, 1), k)))
            w_idx = key_j >> 5
            s0 = s1 = s2 = s3 = 0
            if use_meta or is_sub or is_pos:
                idx = (key_new if use_meta
                       else T.bm[min(max(subj, 0), k - 1)] + (w_idx >> 2)
                       if is_sub else T.pos_base + ((aux + occ_i) >> 2))
                idx = min(max(idx, 0), len(T.small) - 1)
                s0, s1, s2, s3 = (int(v) for v in T.small[idx])
                work[1] += 1
            k_empty = use_meta and s0 == 0
            k_single = use_meta and s0 == 1
            k_multi = use_meta and 2 <= s0 <= T.cmax
            if use_meta and s0 > T.cmax:
                fb_new = True
                ev.update(heavy=True)
            ke_present = k_empty and s2 == 1
            ke_floor = k - 2 <= j0 and k_empty and s2 == 0
            ke_cont = k - 2 > j0 and k_empty and s2 == 0
            pos_take = is_pos
            occ_from_row = quad(s0, s1, s2, s3, aux + occ_i)
            ver_like = is_ver or k_single or k_multi or pos_take
            occ_eff = (s1 if k_single else s2 if k_multi
                       else occ_from_row if pos_take else occ_pos)
            ext_eff = ext if is_ver else 0
            occ_i_eff = 0 if is_key else occ_i
            cnt_eff = s0 if use_meta else cnt
            best_eff = 0 if is_key else best
            aux_eff = s1 if use_meta else aux
            prow_eff = (-1 if k_multi else (aux + occ_i) >> 2 if pos_take
                        else prow)
            if pos_take:
                p0, p1, p2, p3 = s0, s1, s2, s3
            if k_multi:
                occ1c = s3
            vcap = maxlen - k
            cont_occ = more_occ = ver_resolve = cached = False
            ext_new, best_new, occ_i2, occ_from_cache = 0, best_eff, \
                occ_i_eff, 0
            if ver_like:
                tstart = occ_eff + k + ext_eff
                tr = min(max(tstart >> 6, 0), T.nrow - 1)
                col_t = tstart - (tr << 6)
                run_valid = SPAN - max(cmp_off, col_t)
                lim = min(run_valid, vcap - ext_eff)
                f = lim
                if lim > 0:
                    mins = []
                    for t in range(WARP):
                        d0, mine = PER_THREAD * t, SPAN
                        if d0 < lim:
                            ts = text_syms(T, tstart + d0)
                            for i in reversed(range(PER_THREAD)):
                                if d0 + i < lim and rs[t][i] != ts[i]:
                                    mine = d0 + i
                        mins.append(mine)
                    f = min(min(mins), lim)      # the min-reduction
                    work[3] += f + 1 if f < lim else lim
                work[2] += 1
                ext_new = ext_eff + max(f, 0)
                cont_occ = f >= run_valid and ext_new < vcap
                ev.update(lim=lim, f=f, run_valid=run_valid, tstart=tstart,
                          cont=cont_occ)
                if not cont_occ:
                    best_new = max(best_eff, ext_new)
                    more_occ = occ_i_eff + 1 < cnt_eff and best_new < vcap
                    ver_resolve = not more_occ
                if more_occ:
                    occ_i2 = occ_i_eff + 1
                    from_inline = occ_i2 == 1
                    cached = from_inline or ((aux_eff + occ_i2) >> 2
                                             == prow_eff)
                    occ_from_cache = (occ1c if from_inline else
                                      quad(p0, p1, p2, p3, aux_eff + occ_i2))
            sub_present = sub_floor = False
            subj_next = subj
            if is_sub:
                bm_word = quad(s0, s1, s2, s3, w_idx) & 0xFFFFFFFF
                sub_present = bool((bm_word >> (key_j & 31)) & 1)
                if not sub_present:
                    subj_next = subj - 1
                    sub_floor = subj_next <= j0
            m_res = (maxlen if floor_case and clean else subj if sub_present
                     else j0 if sub_floor else k + best_new)
            if ke_present:
                m_res = k - 1
            elif ke_floor:
                m_res = j0
            resolve = ((floor_case and clean) or sub_present or sub_floor
                       or ver_resolve or ke_present or ke_floor)
            prefix_match = resolve and is_b and m_res == maxlen
            to_fwd = resolve and is_b and not prefix_match
            emit = resolve and not is_b
            if emit:
                if count < cap:
                    out.append((anc, m_res + 1))
                count += 1
            emit_done = emit and anc == 0
            restart = emit and not emit_done
            if budget is not None and r >= budget:
                fb_new = True
            if prefix_match or emit_done:
                active = False
            if fb_new:
                fb = True
            mode2 = KEY if to_fwd or restart else mode
            if ke_cont or to_sub_short:
                mode2 = SUB
            if cont_occ or (more_occ and cached):
                mode2 = VER
            if more_occ and not cached:
                mode2 = POS
            mode = mode2
            anc_restart = anc - 1 if overlap == 0 else anc + m_res + overlap
            anc = anc - m_res if to_fwd else anc_restart if restart else anc
            dirb = 0 if to_fwd else 1 if restart else dirb
            if is_key:
                key = key_new
            subj = k - 2 if ke_cont else maxlen if to_sub_short else subj_next
            if use_meta:
                cnt, aux = s0, s1
            occ_i = occ_i2
            occ_pos = (occ_from_cache if more_occ and cached
                       else occ_eff if cont_occ else occ_pos)
            prow = -1 if more_occ and not cached else prow_eff
            ext = (ext_new if cont_occ else 0 if ver_like or is_key
                   else ext)
            best = best_new if ver_like else 0 if is_key else best
            events.append(ev)
        if count > cap:
            overflow = True
        if overflow:
            active = False
    return out, count, r, overflow, fb, active, work


def mirror_batch(T, seqs, lens, cap, max_rounds, overlap=-1, budget=None):
    """K3 a warp per lane: the six result fields, the work counts and the
    rounds' events."""
    Q, Lp1 = seqs.shape
    qs = np.zeros((Q, cap), np.int32)
    ln = np.zeros((Q, cap), np.int32)
    n_sfs = np.zeros(Q, np.int32)
    ovf = np.zeros(Q, bool)
    inc = np.zeros(Q, bool)
    work = np.zeros(4, np.int64)
    iters, events = 0, []
    for q in range(Q):
        out, count, r, o, fb, act, w = run_lane(
            T, seqs[q], Lp1, int(lens[q]), (Lp1 + 63) // 64, cap, max_rounds,
            None if budget is None else int(budget[q]), overlap, events)
        for i, (a, b) in enumerate(out):
            qs[q, i], ln[q, i] = a, b
        n_sfs[q], ovf[q], inc[q] = min(count, cap), o, fb or act
        work += w
        iters = max(iters, r)
    return (qs, ln, n_sfs, ovf, inc, np.int32(iters)), work, events


def mirror_pool(T, syms, offs, lens, Lp1, cap, overlap=-1):
    """K4: each read its own lane (plen = its length), budget 6*len+64."""
    M = len(lens)
    qs = np.zeros((M, cap), np.int32)
    ln = np.zeros((M, cap), np.int32)
    n_sfs = np.zeros(M, np.int32)
    flags = np.zeros(M, np.uint8)
    work = np.zeros(4, np.int64)
    for i in range(M):
        n = int(lens[i])
        out, count, _, o, fb, _, w = run_lane(
            T, syms[offs[i]:offs[i] + n], n, n, (Lp1 + 63) // 64, cap,
            2 ** 31 - 1, 6 * n + 64, overlap, [])
        for j, (a, b) in enumerate(out):
            qs[i, j], ln[i, j] = a, b
        n_sfs[i], flags[i] = min(count, cap), int(fb) | 2 * int(o)
        work += w
    return (qs, ln, n_sfs, flags), work


# ---------------------------------------------------------------- inputs

@pytest.fixture(scope="module")
def edge():
    """The card check's edge-case genome and reads, with the JAX tables
    and the port's tables carried across from them."""
    g, cmax, reads = chip_smoke.lane_edge_case()
    jdev, jparams = anchor_jax.build_device_anchor(
        j_build_anchor_index(j_genome_text({"e": g}), cmax=cmax))
    tdev, tparams = from_arrays(np.asarray(jdev.small),
                                np.asarray(jdev.text_words), jparams, "cpu")
    seqs, lens = j_pack_reads(reads)
    seqs, lens = np.array(seqs), np.array(lens)
    return dict(g=g, reads=reads, jdev=jdev, jparams=jparams, tdev=tdev,
                tparams=tparams, T=Tables(tdev, tparams), seqs=seqs,
                lens=lens)


# the search keywords of each edge case
EDGE_CASES = {"default": {}, "cap2": {"cap": 2}, "overlap0": {"overlap": 0},
              "budget": {"budget": True}, "max_rounds": {"max_rounds": 9}}


def plain_k3(e, kw):
    seqs, lens = torch.from_numpy(e["seqs"]), torch.from_numpy(e["lens"])
    cap = kw.get("cap", 128)
    max_rounds = kw.get("max_rounds") or default_max_rounds(seqs.shape[1])
    budget = (torch.from_numpy(chip_smoke.lane_edge_budget(len(lens)))
              if kw.get("budget") else None)
    work = torch.zeros(4, dtype=torch.int64)
    res = batch_search_anchor_plain(e["tdev"], e["tparams"], seqs, lens,
                                    cap, max_rounds, kw.get("overlap", -1),
                                    budget, work)
    return res, work, cap, max_rounds, budget


# ----------------------------------------------------------------- tests

def test_edge_reads_reach_every_compare_edge(edge):
    """The edge-case reads reach each edge of the warp's key and compare
    steps (seen through the mirror's round events)."""
    T = edge["T"]
    _, _, ev = mirror_batch(T, edge["seqs"], edge["lens"], 128,
                            default_max_rounds(edge["seqs"].shape[1]))
    ver = [e for e in ev if "lim" in e]
    lims = {e["lim"] for e in ver}
    assert {0, 1, 128} <= lims
    assert any(e["lim"] == 128 and e["f"] == 127 for e in ver)
    assert any(e["cont"] and e["mode"] == VER for e in ver)
    # a forward verify that continues past a row's end with 128 symbols
    assert any(e["cont"] for e in ver if e["dirb"] == 0)
    assert any(e["lim"] == 128 for e in ver if e["dirb"] == 0)
    # a compare window past the text's end, and one stopped by its last $
    assert any(e["tstart"] + e["lim"] > T.n for e in ver)
    assert any(e["tstart"] + e["f"] == T.n - 1 for e in ver)
    assert any(e.get("key_dirty") for e in ev)
    assert any(e.get("heavy") for e in ev)
    # key windows across the 64-symbol stride, past the first row, on both
    # strands
    for side in (0, 1):
        assert any(e["mode"] == KEY and e["dirb"] == side and e["m_r"] >= 1
                   and e["col_a"] < 64 <= e["col_a"] + T.k - 1 for e in ev)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_warp_mirror_matches_plain(edge, case):
    """The warp-per-read round (mirror) equals the plain version in all
    six fields and the four work counts."""
    kw = EDGE_CASES[case]
    want, want_work, cap, max_rounds, budget = plain_k3(edge, kw)
    got, work, _ = mirror_batch(
        edge["T"], edge["seqs"], edge["lens"], cap, max_rounds,
        kw.get("overlap", -1), None if budget is None else budget.numpy())
    for f, g in zip(FIELDS, got):
        assert np.array_equal(np.asarray(g), getattr(want, f).numpy()), f
    assert work.tolist() == want_work.tolist(), WORK_FIELDS
    flagged = want.incomplete | want.overflow
    assert bool(flagged.any()) and not bool(flagged.all())
    if case == "budget":
        ok = ~want.incomplete
        assert bool(want.incomplete.any()) and bool(ok.any())


@pytest.mark.parametrize("case", ["default", "cap2", "overlap0",
                                  "max_rounds"])
def test_plain_matches_jax_on_edges(edge, case):
    """The plain version equals anchor_jax.batch_search_anchor on the edge
    reads (the JAX one-shot has no per-lane budget)."""
    kw = EDGE_CASES[case]
    want = anchor_jax.batch_search_anchor(edge["jdev"], edge["jparams"],
                                          edge["seqs"], edge["lens"], **kw)
    got, *_ = plain_k3(edge, kw)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


def test_pool_mirror_matches_plain(edge):
    """K4's lanes (the read alone, no padding, budget 6*len+64) equal the
    pool's plain path on the edge reads, with the work counts."""
    syms, offs, lens = pack_chunk(edge["reads"])
    Lp1 = edge["seqs"].shape[1]
    work = torch.zeros(4, dtype=torch.int64)
    want = pool_search_plain(edge["tdev"], edge["tparams"],
                             torch.from_numpy(syms), torch.from_numpy(offs),
                             torch.from_numpy(lens), Lp1, 64, -1, work)
    got, got_work = mirror_pool(edge["T"], syms, offs, lens, Lp1, 64)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got_work.tolist() == work.tolist()


@pytest.fixture(scope="module")
def pool_tables():
    rng = np.random.default_rng(11)
    genome = {"c1": "".join("ACGT"[i] for i in rng.integers(0, 4, 50_000))}
    jdev, jparams = anchor_jax.build_device_anchor(
        j_build_anchor_index(j_genome_text(genome), cmax=16))
    tdev, tparams = from_arrays(np.asarray(jdev.small),
                                np.asarray(jdev.text_words), jparams, "cpu")
    return genome, jdev, jparams, tdev, tparams


@pytest.mark.parametrize("lanes", [1, 7, 64])
def test_pool_chunks_match_jax_pool(pool_tables, lanes):
    """AnchorPool in chunks of 2 * lanes reads (2, 14, 128) equals the JAX
    package's pool and its one-shot search, read by read."""
    genome, jdev, jparams, tdev, tparams = pool_tables
    n, L, cap = 40, 320, 64
    reads = make_reads(np.random.default_rng(30 + lanes), genome, n, L, 4)
    want = one_shot(jdev, jparams, reads, cap, L)
    jax_pool = JaxPool(jdev, jparams, lanes=lanes, read_len=L, cap=cap,
                       rounds_per_step=40, refill=4, extract=3)
    from_jax = dict(jax_pool.run(reads))
    pool = AnchorPool(tdev, tparams, lanes=lanes, read_len=L, cap=cap)
    assert pool.M == 2 * lanes
    got = run_port(pool, reads)
    assert sorted(got) == list(range(n))
    for i in range(n):
        assert got[i] == from_jax[i] == want[i], i
    assert any(v is None for v in got.values()) and any(got.values())
