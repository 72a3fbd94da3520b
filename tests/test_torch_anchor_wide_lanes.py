"""Kernel K5 (svdss_tpu_torch/csrc/anchor_wide.cu), a warp per lane, held
on the CPU:

- a scalar Python mirror of the kernel's round as a warp runs it: the
  lane's read packed into 2-bit words (16 symbols a word, as the kernel
  packs it into shared memory); the key from one 16-symbol window of
  them, with the count word, the key's aux entry and, a level a thread,
  the bitmap words of a SUB cascade from it loaded at once; each compare
  split over the 32 threads (16 distances a thread: the text from two
  2-bit text words by a funnel shift, the read from two packed words,
  both reversed leftward, one XOR, one min-reduction over (distance,
  order bit), the leftward re-scan as a second reduction). It is held
  against the plain version `run_wave_plain` in all result fields and
  the four work counts, one shot (with the lane state) and in
  parked-phase waves;
- the reads of `chip_smoke.wide_edge_case`, which the card check also
  runs: the mirror shows that they reach each edge of the compare and key
  steps, and the plain version equals
  `anchor_wide_jax.batch_search_anchor_wide` (and its waves) on them.

Integer results: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svdss_tpu.ops import anchor_wide_jax as jw
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu.ops.anchor_wide import make_heavy_resolver as j_resolver
from svdss_tpu_torch.ops import anchor_wide_device as aw
from svdss_tpu_torch.ops.anchor_wide import (build_anchor_index_wide,
                                             make_heavy_resolver)
from svdss_tpu_torch.ops.pingpong import pack_reads

torch.set_num_threads(1)

FIELDS = ("qs", "length", "n_sfs", "overflow", "incomplete", "iters")
WARP, PER_THREAD, SPAN2, STAGE_EVERY = 32, 16, 512, 8
M32, EVEN, NONE = 0xFFFFFFFF, 0x55555555, 1 << 30
KEY, SUB, POS, VER, KEYB, PARKED, RESOLVED = range(7)


def i32(x):
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


# ------------------------------------------------------ the kernel's mirror

class Tables:
    """The kernel's `Tables` from the port's device tables (on the CPU),
    the uint32 arrays as Python ints."""

    def __init__(self, dev, params):
        u = [t.numpy().reshape(-1).astype(np.int64) & M32 for t in dev]
        (self.ct, self.aux, self.pospairs, self.bms, self.text2,
         self.badrow, self.lperm) = u
        self.npp = dev.pospairs.shape[0]
        self.nbms = dev.bms.shape[0]
        self.nrow = dev.text2.shape[0]
        self.nbad, self.nlperm = len(self.badrow), len(self.lperm)
        self.k, self.j0, self.cmax = params.k, params.j0, params.cmax
        self.sorted_b, self.l16 = params.sorted_b, params.l16
        self.ronly, self.ct16 = params.right_only, params.ct16
        self.bm_bases = [0] * 16
        self.bm_bases[params.j0 + 1:params.k] = params.bm_bases


def clamp(x, lo, hi):
    return lo if x < lo else hi if x > hi else x


def pack_read(P, length):
    """The lane's read as 2-bit words, 16 symbols a word (pack_read)."""
    words = []
    for w in range((length + PER_THREAD - 1) // PER_THREAD):
        x = 0
        for i in range(PER_THREAD):
            y = PER_THREAD * w + i
            if y < length:
                x |= clamp(int(P[y]) - 1, 0, 3) << (2 * i)
        words.append(x)
    return words


def rev16(w):
    w = int(f"{w:032b}"[::-1], 2)
    return ((w >> 1) & EVEN) | ((w & EVEN) << 1)


def read16(words, y0):
    """Read symbols y0 .. y0 + 15 from two words by a funnel shift."""
    wi = y0 >> 4

    def word(j):
        return words[j] if 0 <= j < len(words) else 0
    return (((word(wi + 1) << 32) | word(wi)) >> (2 * (y0 & 15))) & M32


def side16(words, w16, side, y0):
    """Symbols y0 .. y0 + 15 of one side (side 1 the reverse complement of
    the read padded to w16)."""
    if side == 0:
        return read16(words, y0)
    return rev16(read16(words, w16 - PER_THREAD - y0)) ^ M32


def bm_word_at(T, key, j):
    """The bitmap word that holds level j's bit of key."""
    key_j = (key & M32) >> (2 * (T.k - clamp(j, 1, T.k)))
    w_idx = key_j >> 5
    bm_row = clamp(T.bm_bases[clamp(j, 0, T.k - 1)] + (w_idx >> 1), 0,
                   T.nbms - 1)
    return int(T.bms[2 * bm_row + (w_idx & 1)])


def pair_at(T, slot):
    row = clamp(slot >> 1, 0, T.npp - 1)
    return int(T.pospairs[2 * row + (slot & 1)])


def rc_key(y, k):
    y = ((y & 0x33333333) << 2) | ((y >> 2) & 0x33333333)
    y = ((y & 0x0F0F0F0F) << 4) | ((y >> 4) & 0x0F0F0F0F)
    y = ((y & 0x00FF00FF) << 8) | ((y >> 8) & 0x00FF00FF)
    y = ((y << 16) | (y >> 16)) & M32
    y >>= 32 - 2 * k
    return y ^ ((1 << (2 * k)) - 1)


def slots(lo, hi):
    """The low bit of each 2-bit slot i in [lo, hi) of a thread's word."""
    lo, hi = max(lo, 0), min(hi, PER_THREAD)
    if hi <= lo:
        return 0
    return ((1 << (2 * hi)) - 1) & ~((1 << (2 * lo)) - 1) & EVEN


def read_part(words, w16, side, rowbase, cmp_off, left, t):
    c0 = cmp_off - PER_THREAD * t if left else cmp_off + PER_THREAD * t
    cols = slots(c0 - (SPAN2 - 1), c0 + 1) if left else slots(-c0,
                                                                SPAN2 - c0)
    word = (rev16(side16(words, w16, side, rowbase + c0 - 15)) if left
            else side16(words, w16, side, rowbase + c0))
    return word, cols


def text_part(T, tr, col_t, left, t):
    lo = (col_t - PER_THREAD * t - (PER_THREAD - 1) if left
          else col_t + PER_THREAD * t)
    wi = lo >> 4

    def word(j):
        return int(T.text2[tr * 32 + j]) if 0 <= j < SPAN2 // 16 else 0
    w = (((word(wi + 1) << 32) | word(wi)) >> (2 * (lo & 15))) & M32
    return rev16(w) if left else w


def first_key(m, tw, qw, t):
    if m == 0:
        return NONE
    i = ((m & -m).bit_length() - 1) >> 1
    ts, qs = (tw >> (2 * i)) & 3, (qw >> (2 * i)) & 3
    return ((PER_THREAD * t + i) << 1) | int(ts < qs)


def compare(T, rp, cmp_off, left, occ, ext0, vcap, work, ev):
    """anchor_wide.cu compare, its warp steps written out over the 32
    threads (rp: each thread's (read word, column slots))."""
    avail_l = (occ - ext0) & M32
    tstart = ((avail_l - 1) if left else (occ + T.k + ext0)) & M32
    tr = tstart >> 8
    if left:
        tr = max(tr - 1, 0)
    tr = clamp(tr, 0, T.nrow - 1)
    col_t = i32(tstart - (tr << 8))
    badw = int(T.badrow[clamp(tr >> 5, 0, T.nbad - 1)])
    avail32 = min(avail_l, 1 << 20)
    run_valid = min(cmp_off, col_t) + 1 if left else \
        SPAN2 - max(cmp_off, col_t)
    run_cap = vcap - ext0
    D = min(run_valid, run_cap)
    if left:
        D = min(D, avail32)
    rescan = left and 0 < avail32 <= SPAN2 and D < avail32
    tws, misms = [0] * WARP, [0] * WARP
    if D > 0 or rescan:
        for t in range(WARP):
            tws[t] = text_part(T, tr, col_t, left, t)
            x = tws[t] ^ rp[t][0]
            misms[t] = (x | (x >> 1)) & rp[t][1]
    key = min(first_key(misms[t] & slots(-16 * t, D - 16 * t), tws[t],
                        rp[t][0], t) for t in range(WARP))
    found = key != NONE
    f = key >> 1
    work[2] += 1
    if D > 0:
        work[3] += f + 1 if found else D
    hit_start = False
    f2 = None
    if left and not found:
        if avail32 <= 0 or D >= avail32:
            hit_start = True
        elif rescan:
            key2 = min(first_key(misms[t] & slots(max(D, 0) - 16 * t,
                                                  SPAN2 + 1 - 16 * t),
                                 tws[t], rp[t][0], t) for t in range(WARP))
            f2 = key2 >> 1 if key2 != NONE else None
            hit_start = (f2 if f2 is not None else SPAN2) >= avail32
    first = f if found else D
    run = min(first, run_valid, run_cap)
    ext_after = ext0 + max(run, 0)
    survive = first >= run_valid and ext_after < vcap and not hit_start
    ev.append(dict(D=D, f=f if found else None, left=left, avail=avail32,
                   rescan=rescan, f2=f2, hit_start=hit_start,
                   survive=survive, run_valid=run_valid))
    return (ext_after, survive, bool((badw >> (tr & 31)) & 1),
            hit_start or (found and bool(key & 1)))


def run_lane(T, P, length, nwm, cap, max_rounds, overlap, park, r0, L, oq,
             ol, work, events):
    """anchor_wide.cu run_lane for one lane state dict L; `events` gets one
    dict per round. Returns the round at which the lane stopped."""
    k, j0 = T.k, T.j0
    w16 = 256 * (nwm + 1)
    r = r0
    words = pack_read(P, length)
    n_lv = k - 1 - j0
    bm_pre, bm_ok = [0] * WARP, False   # thread i: level j0 + 1 + i of key

    def runnable():
        return L["active"] and not L["fb"] and not (park
                                                    and L["mode"] == PARKED)
    while runnable() and r < max_rounds:
        blk_end = r + STAGE_EVERY
        while runnable() and r < max_rounds and r < blk_end:
            r += 1
            work[0] += 1
            mode = L["mode"]
            is_b = L["dirb"] == 1
            u = length - 1 - L["anc"] if is_b else L["anc"]
            maxlen = L["anc"] + 1 if is_b else length - L["anc"]
            is_key, is_keyb = mode == KEY, mode == KEYB
            is_sub, is_pos, is_ver = mode == SUB, mode == POS, mode == VER
            is_res = park and mode == RESOLVED
            on_b = L["strand"] == 1 and not is_key
            probe_pos = T.sorted_b and is_pos and not (T.ronly
                                                       and L["strand"] == 1)
            ext_eff = (L["ext"] if is_ver else min(L["llcp"], L["rlcp"])
                       if probe_pos else 0)
            use_left = on_b and (is_keyb or is_pos or is_ver)
            rstart = (length - 1 - (u + k + ext_eff) if use_left
                      else u if is_key else u + k + ext_eff)
            side = 1 - L["dirb"] if use_left else L["dirb"]
            if side == 1:
                rstart += w16 - length
            m_r = (clamp((rstart >> 8) - 1, 0, nwm - 1) if use_left
                   else clamp(rstart >> 8, 0, nwm - 1))
            rowbase = m_r << 8
            col_a = rstart - rowbase
            on_b_eff = on_b or is_keyb
            cmp_off = col_a + k if is_key else col_a
            ev = dict(mode=mode, dirb=L["dirb"], side=side, m_r=m_r,
                      col_a=col_a, cmps=[])
            rp = [(0, 0)] * WARP
            if is_key or is_keyb or is_pos or is_ver:
                rp = [read_part(words, w16, side, rowbase, cmp_off, on_b_eff,
                                t) for t in range(WARP)]
            key = 0
            if is_key:          # one window, digits outside the row cut
                keep = slots(-col_a, SPAN2 - col_a) & slots(0, k)
                key = rev16(side16(words, w16, side, rowbase + col_a)
                            & (keep | keep << 1)) >> (2 * (PER_THREAD - k))
                ev["key_cut"] = not (0 <= col_a and col_a + k <= SPAN2)
            keyb_new = rc_key(key, k)
            floor_case = is_key and maxlen <= j0
            use_meta = is_key and maxlen >= k
            to_sub_short = is_key and j0 < maxlen < k
            if is_key:          # the SUB cascade's words, a level a thread
                bm_ok = use_meta or to_sub_short
                if bm_ok:
                    bm_pre = [bm_word_at(T, key, j0 + 1 + t) if t < n_lv
                              else 0 for t in range(WARP)]
            cnt_a = ctot = 0
            aux_key = 0
            if use_meta:        # the count word and the key's aux entry
                aux_key = int(T.aux[clamp(key, 0, len(T.aux) - 1)])
                work[1] += 1
                if T.ct16:
                    w = int(T.ct[key >> 1])
                    v = (w >> ((key & 1) * 16)) & 0xFFFF
                    cnt_a, ctot = v & 0xFF, (v >> 8) & 0xFF
                else:
                    w = int(T.ct[key])
                    cnt_a, ctot = w & 0xFFFF, w >> 16
            cnt_b = ctot - cnt_a
            k_heavy = use_meta and ctot > T.cmax
            k_empty = use_meta and ctot == 0
            fb_new = (not park) and k_heavy
            start_a = use_meta and not k_heavy and not k_empty and cnt_a >= 1
            skip_to_b = use_meta and not k_heavy and not k_empty \
                and cnt_a == 0
            a_single, a_multi = start_a and cnt_a == 1, start_a and cnt_a >= 2
            b_single = is_keyb and L["cntb"] == 1
            b_multi = is_keyb and L["cntb"] >= 2
            aux_g = 0
            if start_a or is_keyb:
                work[1] += 1
                aux_g = aux_key if is_key else int(
                    T.aux[clamp(L["keyb"], 0, len(T.aux) - 1)])
            chain_multi = a_multi or b_multi
            lo_eff = bhi_eff = mid_eff = 0
            is_linb = False
            if T.sorted_b:
                lo_eff = 0 if is_key or is_keyb else L["occ_i"]
                bhi_eff = cnt_a if start_a else L["cntb"] if is_keyb \
                    else L["bhi"]
                mid_eff = (lo_eff + bhi_eff) >> 1
                aux_for = aux_g if is_key or is_keyb else L["aux"]
                sel = mid_eff
                if T.ronly:
                    is_linb = on_b or is_keyb
                    if is_linb:
                        sel = lo_eff
                elif b_multi or (is_pos and L["strand"] == 1):
                    work[1] += 1
                    lslot = (aux_for + mid_eff) & M32
                    if T.l16:
                        lw = int(T.lperm[clamp(lslot >> 1, 0,
                                               T.nlperm - 1)])
                        sel = (lw >> ((lslot & 1) * 16)) & 0xFFFF
                    else:
                        lw = int(T.lperm[clamp(lslot >> 2, 0,
                                               T.nlperm - 1)])
                        sel = (lw >> ((lslot & 3) * 8)) & 0xFF
                want_probe = a_multi or b_multi or is_pos
                occ_probe = 0
                if want_probe:
                    work[1] += 1
                    occ_probe = pair_at(T, (aux_for + sel) & M32)
                occ_eff = (aux_g if a_single or b_single else occ_probe
                           if want_probe else L["occ_pos"])
                occ_i_eff = lo_eff
            else:
                occ0 = occ_row = 0
                if chain_multi:
                    work[1] += 1
                    occ0 = pair_at(T, aux_g)
                if is_pos:
                    work[1] += 1
                    occ_row = pair_at(T, (L["aux"] + L["occ_i"]) & M32)
                occ_eff = (aux_g if a_single or b_single else occ0
                           if chain_multi else occ_row if is_pos
                           else L["occ_pos"])
                occ_i_eff = 0 if is_key or is_keyb else L["occ_i"]
            ver_like = is_ver or a_single or a_multi or b_single or b_multi \
                or is_pos
            cnt_eff = cnt_a if start_a else L["cntb"] if is_keyb else L["cnt"]
            best_eff = 0 if is_key else L["best"]
            aux_eff = aux_g if is_key or is_keyb else L["aux"]
            left_cmp = ver_like and on_b_eff
            j2, pair_ok, occ_2nd = occ_i_eff, False, 0
            if not T.sorted_b or T.ronly:
                j2 = occ_i_eff + 1
                pair_ok = (ver_like and ext_eff == 0 and j2 < cnt_eff
                           and not (a_single or b_single)
                           and (not T.ronly or is_linb))
                if pair_ok:
                    work[1] += 1
                    occ_2nd = pair_at(T, (aux_eff + j2) & M32)
            vcap = maxlen - k
            c1 = c2 = (0, False, False, False)
            if ver_like:
                c1 = compare(T, rp, cmp_off, left_cmp, occ_eff, ext_eff,
                             vcap, work, ev["cmps"])
            if pair_ok:
                c2 = compare(T, rp, cmp_off, left_cmp, occ_2nd, 0, vcap,
                             work, ev["cmps"])
            if c1[2] or c2[2]:
                fb_new = True
            best_new = max(best_eff, c1[0]) if ver_like and not c1[1] \
                else best_eff
            cont_from2 = False
            occ_i2, bhi2 = 0, L["bhi"]
            llcp2, rlcp2 = L["llcp"], L["rlcp"]
            if T.sorted_b:
                if T.ronly and pair_ok and not c2[1]:
                    best_new = max(best_new, c2[0])
                early = best_new >= vcap
                done1 = ver_like and not c1[1]
                lo2 = mid_eff + 1 if done1 and c1[3] else lo_eff
                hi2 = mid_eff if done1 and not c1[3] else bhi_eff
                probe_ctx = ver_like and not is_linb if T.ronly else ver_like
                llcp_eff = 0 if is_key or is_keyb else L["llcp"]
                rlcp_eff = 0 if is_key or is_keyb else L["rlcp"]
                llcp2 = c1[0] if done1 and probe_ctx and c1[3] else llcp_eff
                rlcp2 = c1[0] if done1 and probe_ctx and not c1[3] \
                    else rlcp_eff
                if T.ronly:
                    cont_a = ver_like and not is_linb and not early and c1[1]
                    cont_b = ver_like and is_linb and not early and (
                        c1[1] or (pair_ok and c2[1]))
                    cont_occ = cont_a or cont_b
                    cont_from2 = is_linb and not c1[1] and pair_ok and c2[1]
                    occ_done = ver_like and not cont_occ
                    next_i = occ_i_eff + (2 if pair_ok else 1)
                    more_occ = ((occ_done and not is_linb and lo2 < hi2
                                 and not early)
                                or (occ_done and is_linb and next_i < cnt_eff
                                    and not early))
                    if ver_like and is_linb:
                        occ_i2 = (next_i if occ_done and next_i < cnt_eff
                                  and not early else j2 if cont_from2
                                  else occ_i_eff)
                    else:
                        occ_i2 = lo2 if ver_like else occ_i_eff
                    bhi2 = hi2 if ver_like and not is_linb else bhi_eff
                else:
                    cont_occ = ver_like and not early and c1[1]
                    occ_done = ver_like and not cont_occ
                    more_occ = occ_done and lo2 < hi2 and not early
                    occ_i2 = lo2 if ver_like else occ_i_eff
                    bhi2 = hi2 if ver_like else bhi_eff
            else:
                if pair_ok and not c2[1]:
                    best_new = max(best_new, c2[0])
                early = best_new >= vcap
                cont_occ = ver_like and not early and (c1[1] or (pair_ok
                                                                 and c2[1]))
                cont_from2 = not c1[1] and pair_ok and c2[1]
                occ_done = ver_like and not cont_occ
                next_i = occ_i_eff + (2 if pair_ok else 1)
                more_occ = occ_done and next_i < cnt_eff and not early
                occ_i2 = next_i if more_occ else j2 if cont_from2 \
                    else occ_i_eff
            ev.update(pair_ok=pair_ok, cont_from2=cont_from2)
            cntb_eff = cnt_b if is_key else L["cntb"]
            to_b = (occ_done and not more_occ and L["strand"] == 0
                    and not on_b_eff and cntb_eff >= 1 and not early) \
                or skip_to_b
            ver_resolve = occ_done and not more_occ and not to_b
            sub_present = sub_floor = False
            subj_next = L["subj"]
            if is_sub:
                work[1] += 1
                key_j = (L["key"] & M32) >> (2 * (k - clamp(L["subj"], 1, k)))
                lv = L["subj"] - j0 - 1
                bm_word = (bm_pre[lv] if bm_ok and 0 <= lv < n_lv   # shuffle
                           else bm_word_at(T, L["key"], L["subj"]))
                sub_present = bool((bm_word >> (key_j & 31)) & 1)
                if not sub_present:
                    subj_next = L["subj"] - 1
                    sub_floor = subj_next <= j0
            m_res = (maxlen if floor_case else L["subj"] if sub_present
                     else j0 if sub_floor else k + best_new)
            resolve = floor_case or sub_present or sub_floor or ver_resolve
            if is_res:
                m_res, resolve = L["inj_m"], True
            b_res = resolve and is_b
            prefix_match = b_res and m_res == maxlen
            to_fwd = b_res and not prefix_match
            emit = resolve and not is_b
            if emit:
                if L["nsfs"] < cap:
                    oq[L["nsfs"]] = L["anc"]
                    ol[L["nsfs"]] = m_res + 1
                L["nsfs"] += 1
            emit_done = emit and L["anc"] == 0
            restart = emit and not emit_done
            if prefix_match or emit_done:
                L["active"] = False
            if fb_new:
                L["fb"] = True
            mode2 = KEY if to_fwd or restart else mode
            if k_empty or to_sub_short:
                mode2 = SUB
            if cont_occ:
                mode2 = VER
            if more_occ:
                mode2 = POS
            if to_b:
                mode2 = KEYB
            if park and k_heavy:
                mode2 = PARKED
            L["mode"] = mode2
            anc_restart = L["anc"] - 1 if overlap == 0 \
                else L["anc"] + m_res + overlap
            L["anc"] = L["anc"] - m_res if to_fwd else anc_restart \
                if restart else L["anc"]
            L["dirb"] = 0 if to_fwd else 1 if restart else L["dirb"]
            L["strand"] = 0 if to_fwd or restart else 1 if to_b \
                else L["strand"]
            if is_key:
                L["key"], L["keyb"], L["cntb"] = i32(key), i32(keyb_new), \
                    cnt_b
            L["subj"] = k - 1 if k_empty else maxlen if to_sub_short \
                else subj_next
            L["cnt"], L["aux"] = cnt_eff, aux_eff
            L["occ_i"], L["bhi"] = occ_i2, bhi2
            L["llcp"], L["rlcp"] = llcp2, rlcp2
            if cont_occ:
                L["occ_pos"] = occ_2nd if cont_from2 else occ_eff
                L["ext"] = c2[0] if cont_from2 else c1[0]
            elif ver_like or is_key or is_keyb:
                L["ext"] = 0
            L["best"] = best_new if ver_like else 0 if is_key else L["best"]
            events.append(ev)
        if L["nsfs"] > cap:
            L["overflow"] = True
        if L["overflow"]:
            L["active"] = False
        L["nsfs"] = min(L["nsfs"], cap)
    return r


def mirror_wave(T, seqs, lens, state, out_qs, out_l, rounds, r0, cap,
                max_rounds, overlap, park, work=None, events=None):
    """run_wave on the mirror: every lane of the [22, Q] state from r0, the
    state, emissions and round count updated in place as K5 leaves them."""
    Q, Lp1 = seqs.shape
    nwm = 2 * ((Lp1 + 255) // 256 + 1) - 1
    st, oq, ol = state.numpy(), out_qs.numpy(), out_l.numpy()
    counts = [0, 0, 0, 0]
    r_max = r0
    for q in range(Q):
        L = {name: int(st[i, q]) for i, name in enumerate(aw.STATE)}
        for f in ("aux", "occ_pos"):
            L[f] &= M32
        for f in ("active", "fb", "overflow"):
            L[f] = L[f] != 0
        r = run_lane(T, seqs[q].numpy(), int(lens[q]), nwm, cap, max_rounds,
                     overlap, park, r0, L, oq[q], ol[q], counts,
                     [] if events is None else events)
        for i, name in enumerate(aw.STATE):
            st[i, q] = i32(int(L[name]))
        r_max = max(r_max, r)
    rounds.fill_(r_max)
    if work is not None:
        work += torch.tensor(counts, dtype=torch.int64)


def one_shot(wave, seqs, lens, cap=128, max_rounds=0, overlap=-1, **kw):
    """A one-shot batch through `wave` (the mirror's or the plain
    version's): the six result fields, the work counts and the final
    [22, Q] lane state."""
    state = aw.reset_state(seqs, lens)
    oq = torch.zeros((seqs.shape[0], cap), dtype=torch.int32)
    ol = torch.zeros_like(oq)
    rounds = torch.zeros(1, dtype=torch.int32)
    work = torch.zeros(4, dtype=torch.int64)
    wave(seqs, lens, state, oq, ol, rounds, 0, cap,
         max_rounds or aw.default_max_rounds(seqs.shape[1]), overlap, False,
         work, **kw)
    return aw.result_of(state, oq, ol, rounds), work, state


def mirror_one_shot(T, seqs, lens, events=None, **kw):
    return one_shot(lambda *a, **k: mirror_wave(T, *a, **k), seqs, lens,
                    events=events, **kw)


def plain_one_shot(tab, seqs, lens, **kw):
    chunks = aw.read_chunks(seqs, lens)

    def wave(seqs, *a):
        aw.run_wave_plain(tab["dev"], tab["params"], chunks, *a)
    return one_shot(wave, seqs, lens, **kw)


def mirror_waves_class(T):
    """WideWaveRun with its waves run by the mirror."""
    class MirrorWaves(aw.WideWaveRun):
        def _wave(self, r0):
            mirror_wave(T, self.seqs, self.lens, self.state, self.out_qs,
                        self.out_l, self.rounds, r0, self.cap,
                        self.max_rounds, self.overlap, True, self.work)
    return MirrorWaves


# ---------------------------------------------------------------- inputs

@pytest.fixture(scope="module")
def edge():
    """The card check's wide edge-case genome and reads, with the port's
    and the JAX package's tables for each build of the case."""
    text, builds, reads = chip_smoke.wide_edge_case()
    seqs, lens = pack_reads(reads, device="cpu")
    tabs = {}
    for name, build in builds.items():
        widx = build_anchor_index_wide(text.copy(), **build)
        dev, params = aw.build_device_anchor_wide(widx, "cpu")
        jidx = j_build_anchor_index_wide(text.copy(), **build)
        tabs[name] = dict(widx=widx, dev=dev, params=params,
                          T=Tables(dev, params), jidx=jidx,
                          jtab=jw.build_device_anchor_wide(jidx))
    return dict(reads=reads, seqs=seqs, lens=lens, tabs=tabs)


EDGE_CASES = {"default": {}, "cap2": {"cap": 2}, "overlap0": {"overlap": 0},
              "max_rounds": {"max_rounds": 40}}


# ------------------------------------------------------------------ tests

def test_edge_reads_reach_every_compare_edge(edge):
    """The wide edge-case reads reach each edge of the warp's key and
    compare steps (seen through the mirror's round events), over the
    case's table builds together."""
    ev = []
    for tab in edge["tabs"].values():
        mirror_one_shot(tab["T"], edge["seqs"], edge["lens"], events=ev)
    cmps = [c for e in ev for c in e["cmps"]]
    assert {0, 1, SPAN2} <= {c["D"] for c in cmps}
    assert any(c["D"] == SPAN2 and c["f"] == SPAN2 - 1 for c in cmps)
    # leftward runs that reach the text start: re-scanned (avail <= 512)
    # and decided without a re-scan; and leftward runs past 512 available
    left = [c for c in cmps if c["left"] and c["f"] is None]
    assert any(c["rescan"] and c["avail"] <= SPAN2 for c in left)
    assert any(c["hit_start"] and not c["rescan"] for c in left)
    assert any(c["avail"] > SPAN2 for c in left)
    # pair-verify rounds whose first candidate fails and second survives
    assert any(e["pair_ok"] and e["cont_from2"] for e in ev)
    # rows across the 256-symbol stride on both sides, key windows cut at
    # the row's edge
    for side in (0, 1):
        assert any(e["side"] == side and e["m_r"] >= 1 for e in ev)
    assert any(e.get("key_cut") for e in ev)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_warp_mirror_matches_plain(edge, case):
    """The warp-per-lane round (mirror) equals the plain version in all
    six fields, the four work counts and the final lane state (which
    carries the key of a window cut at the row's edge), on every table
    build. The state's aux row is left out: a KEY round that reads no aux
    entry leaves 0 there in the kernel (as in its parent) and the entry
    the plain version gathers for every lane in its own; only a round that
    read one reads it later."""
    kw = EDGE_CASES[case]
    for tab in edge["tabs"].values():
        want, want_work, want_state = plain_one_shot(
            tab, edge["seqs"], edge["lens"], **kw)
        got, work, state = mirror_one_shot(tab["T"], edge["seqs"],
                                           edge["lens"], **kw)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert work.tolist() == want_work.tolist(), aw.WORK_FIELDS
        rows = [i for i, name in enumerate(aw.STATE) if name != "aux"]
        assert torch.equal(state[rows], want_state[rows])


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_matches_jax_on_edges(edge, case):
    """The plain version equals anchor_wide_jax.batch_search_anchor_wide on
    the edge reads, on every table build."""
    kw = dict(dict(cap=128), **EDGE_CASES[case])
    for tab in edge["tabs"].values():
        got, _, _ = plain_one_shot(tab, edge["seqs"], edge["lens"],
                                   **EDGE_CASES[case])
        jdev, jparams = tab["jtab"]
        want = jw.batch_search_anchor_wide(
            jdev, jparams, jnp.asarray(edge["seqs"].numpy()),
            jnp.asarray(edge["lens"].numpy()), **kw)
        for f in FIELDS:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f


class Asked:
    def __init__(self, resolver, encs):
        self.resolver, self.encs, self.calls = resolver, encs, []

    def __call__(self, lanes, ancs, dirbs):
        self.calls.append((np.asarray(lanes).tolist(),
                           np.asarray(ancs).tolist(),
                           np.asarray(dirbs).tolist()))
        return np.array([self.resolver(self.encs[int(ln)], int(a),
                                       "left" if d == 1 else "right")
                         for ln, a, d in zip(lanes, ancs, dirbs)],
                        dtype=np.int32)


@pytest.mark.parametrize("park_limit", [16, 1])
def test_waves_mirror_plain_and_jax(edge, park_limit):
    """In parked-phase waves on the heavy build: the mirror's waves equal
    the plain version's (fields, work counts, waves, parked lanes, the
    phases asked) and the JAX package's."""
    tab = edge["tabs"]["heavy"]
    reads, seqs, lens = edge["reads"], edge["seqs"], edge["lens"]
    runs = []
    for runner in (aw.WideWaveRun, mirror_waves_class(tab["T"])):
        asked = Asked(make_heavy_resolver(tab["widx"]), reads)
        work = torch.zeros(4, dtype=torch.int64)
        run = runner(tab["dev"], tab["params"], seqs, lens, asked,
                     park_limit=park_limit, work=work)
        runs.append((run.finish(), work, asked.calls, run.n_waves,
                     run.parked_lanes))
    (want, wwork, wcalls, wn, wp), (got, gwork, gcalls, gn, gp) = runs
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert gwork.tolist() == wwork.tolist()
    assert (gcalls, gn, gp) == (wcalls, wn, wp)
    assert wn >= 1 and wp >= 1
    jdev, jparams = tab["jtab"]
    jasked = Asked(j_resolver(tab["jidx"]), reads)
    jres = jw.batch_search_anchor_wide_waves(
        jdev, jparams, jnp.asarray(seqs.numpy()), jnp.asarray(lens.numpy()),
        jasked, park_limit=park_limit)
    for f in FIELDS:
        assert np.array_equal(getattr(want, f).numpy(),
                              np.asarray(getattr(jres, f))), f
    assert jasked.calls == wcalls
