// Kernel K5 (anchor_wide): the wide anchor-verify SFS search over
// forward-strand tables with uint32 coordinates, one thread per read lane,
// in one-shot form (park = 0: a heavy k-mer sends the read to the host)
// and as one wave of the parked-phase driver (park = 1: the lane parks and
// the host answers the phase before the next wave).
//
// Replaces svdss_tpu/ops/anchor_wide_jax.py:1144 batch_search_anchor_wide
// and :941 _wave_step (XLA while-loops over the round body
// _make_round_body_wide :346, with the emission merge _merge_stage_wide
// :905 every 8 rounds; helpers _funnel_shift2 :221, _select_sym2 :243,
// _rc_key :252, _pack_chunks2 :930). Results equal the JAX functions'
// field for field: qs/length in emission order, n_sfs = min(count, cap),
// overflow checked every 8 rounds counted from the wave's first round r0,
// incomplete = fb | active, and the round count, which carries from wave
// to wave (a lane resuming in a wave starts at that wave's r0, and
// max_rounds bounds the total). The round counts, and with them which
// lanes are incomplete, follow the TPU's data layout: reads and text in
// 512-symbol span rows at stride 256, 2 bits a symbol. A verify round
// compares at most to the end of either row (run_valid), to the read's
// end (run_cap) and, leftward, to the text start; the kernel never builds
// the rows, it computes their offsets from the padded width Lp1 and reads
// symbols straight from the read (side 1 as its reverse complement) and
// the 2-bit text.
//
// What bounds it on an H100: each round of a lane makes a short chain of
// dependent reads at data-dependent addresses: the fused count word and
// the aux entry (4^k entries each: 1 GiB at k = 14, far past the 50 MB
// L2), then a poslist pair, then a run of text words. A lane is a serial
// chain of such rounds, so the kernel is bound by memory latency, not by
// bytes or operations; the bytes the work must move are those words and
// the symbols compared.
//
// What the design does about it: lane state lives in registers and a lane
// runs to completion (or to a park) with no lockstep barrier, so no lane
// waits for the batch's slowest one (the XLA loop ran every lane to the
// batch's last round). The TPU's row gathers, funnel shift, word-level
// mismatch scan and [Q, 8] emission staging are gone: a thread compares
// symbols in a loop and writes emissions straight to [Q, cap]. Between
// waves the state stays in the device tensor `state` ([22, Q] int32) that
// a launch reads at entry and writes back at exit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPAN2 = 512;       // symbols per span row
constexpr int STAGE_EVERY = 8;   // rounds between overflow checks
constexpr int THREADS = 64;
enum { KEY = 0, SUB = 1, POS = 2, VER = 3, KEYB = 4, PARKED = 5,
       RESOLVED = 6 };
// rows of the state tensor (ops/anchor_wide_device.py STATE)
enum { S_ACTIVE, S_FB, S_DIRB, S_MODE, S_ANC, S_STRAND, S_KEY, S_KEYB,
       S_CNTB, S_SUBJ, S_CNT, S_AUX, S_OCC_I, S_BHI, S_LLCP, S_RLCP,
       S_INJ_M, S_OCC_POS, S_EXT, S_BEST, S_NSFS, S_OVERFLOW, NSTATE };

struct Tables {
  const uint32_t* ct;        // fused counts
  const uint32_t* aux;       // [4^k]
  const uint32_t* pospairs;  // [npp, 2]
  const uint32_t* bms;       // [nbms, 2]
  const uint32_t* text2;     // [nrow, 32] 2-bit span rows
  const uint32_t* badrow;    // [nbad] bits
  const uint32_t* lperm;     // [nlperm] packed uint8 / uint16
  long long n_ct, n_aux, npp, nbms, nrow, nbad, nlperm;
  int k, j0, cmax;
  bool sorted_b, l16, ronly, ct16;
  int bm_bases[16];          // first bitmap row of level j (0 for j <= j0)
};

struct Lane {
  bool active, fb, overflow;
  int dirb, mode, anc, strand, key, keyb, cntb, subj, cnt;
  uint32_t aux;
  int occ_i, bhi, llcp, rlcp, inj_m;
  uint32_t occ_pos;
  int ext, best, nsfs;       // nsfs counts past cap inside a block of 8
};

struct Work {
  unsigned long long rounds = 0, rows = 0, text = 0, syms = 0;
};

// the read: its bytes, its length, the packed side width 256*(nwm+1)
struct Read {
  const uint8_t* P;
  int len, w16;
};

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 2-bit value of read symbol y (nt6 - 1; 0 past the read)
__device__ __forceinline__ int rsym(const Read& R, int y) {
  if (y < 0 || y >= R.len) return 0;
  return clampv((int)R.P[y] - 1, 0, 3);
}

// symbol at packed position y of one side: side 0 is the read, side 1 the
// complement of the read zero-padded to w16 and reversed
__device__ __forceinline__ int side_sym(const Read& R, int side, int y) {
  return side == 0 ? rsym(R, y) : 3 - rsym(R, R.w16 - 1 - y);
}

__device__ __forceinline__ uint32_t pair_at(const Tables& T, uint32_t slot) {
  const long long row = clampv((long long)(slot >> 1), 0LL, T.npp - 1);
  return __ldg(T.pospairs + 2 * (size_t)row + (slot & 1u));
}

__device__ __forceinline__ uint32_t rc_key(uint32_t y, int k) {
  y = ((y & 0x33333333u) << 2) | ((y >> 2) & 0x33333333u);
  y = ((y & 0x0F0F0F0Fu) << 4) | ((y >> 4) & 0x0F0F0F0Fu);
  y = ((y & 0x00FF00FFu) << 8) | ((y >> 8) & 0x00FF00FFu);
  y = (y << 16) | (y >> 16);
  y >>= 32 - 2 * k;
  return y ^ ((1u << (2 * k)) - 1u);
}

struct Cmp {
  int ext_after;
  bool survive, row_bad, lt;
};

// One verify compare of the read row (side, rowbase = 256*m_r) from column
// cmp_off against occurrence occ at extension ext0, rightward or (left)
// leftward; the anchor_wide_jax.py compare() :595 in scalar form.
struct Scan {
  const Tables& T;
  const Read& R;
  int side, rowbase, cmp_off, s;
  long long tr;
  bool left;
  long long wcache_i = -1;
  uint32_t wcache = 0;

  __device__ int text_at(int c) {     // text row symbol c (0 outside)
    if (c < 0 || c >= SPAN2) return 0;
    const long long wi = tr * 32 + (c >> 4);
    if (wi != wcache_i) {
      wcache = __ldg(T.text2 + (size_t)wi);
      wcache_i = wi;
    }
    return (wcache >> (2 * (c & 15))) & 3;
  }

  // first distance d in [d0, d1) where the row's symbols differ (the
  // read row's columns outside [0, 512) take no part), else -1; the two
  // symbols there in *t, *q
  __device__ int first(int d0, int d1, int* t, int* q) {
    for (int d = d0; d < d1; ++d) {
      const int c = left ? cmp_off - d : cmp_off + d;
      if (c < 0 || c >= SPAN2) {
        if (left ? c < 0 : c >= SPAN2) break;
        continue;
      }
      const int ts = text_at(c + s);
      const int qs = side_sym(R, side, rowbase + c);
      if (ts != qs) {
        *t = ts;
        *q = qs;
        return d;
      }
    }
    return -1;
  }
};

__device__ Cmp compare(const Tables& T, const Read& R, int side, int rowbase,
                       int cmp_off, bool left, uint32_t occ, int ext0,
                       int vcap, Work& wk) {
  const uint32_t avail_l = occ - (uint32_t)ext0;
  const uint32_t tstart = left ? avail_l - 1u
                               : occ + (uint32_t)T.k + (uint32_t)ext0;
  long long tr = (long long)(tstart >> 8);
  if (left) tr = tr - 1 < 0 ? 0 : tr - 1;
  tr = clampv(tr, 0LL, T.nrow - 1);
  const int col_t = (int)(tstart - ((uint32_t)tr << 8));
  const uint32_t badw =
      __ldg(T.badrow + clampv(tr >> 5, 0LL, T.nbad - 1));
  const int avail32 = (int)(avail_l < (1u << 20) ? avail_l : (1u << 20));
  const int run_valid = left ? min(cmp_off, col_t) + 1
                             : SPAN2 - max(cmp_off, col_t);
  const int run_cap = vcap - ext0;
  int D = min(run_valid, run_cap);
  if (left) D = min(D, avail32);
  Scan sc{T, R, side, rowbase, cmp_off, col_t - cmp_off, tr, left};
  int tsym = 0, qsym = 0;
  const int f = sc.first(0, D, &tsym, &qsym);
  const bool found = f >= 0;
  ++wk.text;
  if (D > 0) wk.syms += found ? f + 1 : D;
  // a run that reaches the text start (leftward): past D the TPU's scan
  // goes on to its row's end, comparing against zeros where the text row
  // has ended, and the first mismatch it finds decides (avail <= 512 only
  // when the text row is the first)
  bool hit_start = false;
  if (left && !found) {
    if (avail32 <= 0 || D >= avail32) {
      hit_start = true;
    } else if (avail32 <= SPAN2) {
      int t2, q2;
      const int f2 = sc.first(max(D, 0), SPAN2 + 1, &t2, &q2);
      hit_start = (f2 >= 0 ? f2 : SPAN2) >= avail32;
    }
  }
  // with no mismatch within D, D stands for the first: run and survive
  // come out as with the TPU's exact first
  const int first = found ? f : D;
  const int run = min(min(first, run_valid), run_cap);
  Cmp r;
  r.ext_after = ext0 + max(run, 0);
  r.survive = first >= run_valid && r.ext_after < vcap && !hit_start;
  r.row_bad = (badw >> (tr & 31)) & 1u;
  r.lt = hit_start || (found && tsym < qsym);
  return r;
}

// One lane from round r0 until it ends, parks (park) or reaches
// max_rounds, in blocks of 8 rounds with the overflow check after each.
// Returns the round at which it stopped.
__device__ int run_lane(const Tables& T, const Read& R, int nwm, int cap,
                        int max_rounds, int overlap, bool park, int r0,
                        Lane& L, int32_t* oq, int32_t* ol, Work& wk) {
  const int k = T.k, j0 = T.j0;
  int r = r0;
  auto runnable = [&]() {
    return L.active && !L.fb && !(park && L.mode == PARKED);
  };
  while (runnable() && r < max_rounds) {
    const int blk_end = r + STAGE_EVERY;
    while (runnable() && r < max_rounds && r < blk_end) {
      ++r;
      ++wk.rounds;
      const int mode = L.mode;
      const bool is_b = L.dirb == 1;
      const int u = is_b ? R.len - 1 - L.anc : L.anc;
      const int maxlen = is_b ? L.anc + 1 : R.len - L.anc;
      const bool is_key = mode == KEY, is_keyb = mode == KEYB;
      const bool is_sub = mode == SUB, is_pos = mode == POS;
      const bool is_ver = mode == VER;
      const bool is_res = park && mode == RESOLVED;
      const bool on_b = L.strand == 1 && !is_key;

      // the read row: right compares read side dirb forward; left
      // compares the other side backward from the mirror cursor; a
      // re-probe of a sorted bucket starts at min(llcp, rlcp)
      const bool probe_pos =
          T.sorted_b && is_pos && !(T.ronly && L.strand == 1);
      const int ext_eff = is_ver ? L.ext
                          : probe_pos ? min(L.llcp, L.rlcp) : 0;
      const bool use_left = on_b && (is_keyb || is_pos || is_ver);
      int rstart = use_left ? R.len - 1 - (u + k + ext_eff)
                            : (is_key ? u : u + k + ext_eff);
      const int side = use_left ? 1 - L.dirb : L.dirb;
      if (side == 1) rstart += R.w16 - R.len;
      const int m_r = use_left ? clampv((rstart >> 8) - 1, 0, nwm - 1)
                               : clampv(rstart >> 8, 0, nwm - 1);
      const int rowbase = m_r << 8;
      const int col_a = rstart - rowbase;

      // KEY: the k-mer at col_a (digit i = symbol i) and its RC key
      uint32_t key = 0;
      if (is_key) {
        for (int i = 0; i < k; ++i) {
          const int c = col_a + i;
          const int sym =
              (c >= 0 && c < SPAN2) ? side_sym(R, side, rowbase + c) : 0;
          key |= (uint32_t)sym << (2 * (k - 1 - i));
        }
      }
      const uint32_t keyb_new = rc_key(key, k);
      const bool floor_case = is_key && maxlen <= j0;
      const bool use_meta = is_key && maxlen >= k;
      const bool to_sub_short = is_key && maxlen > j0 && maxlen < k;

      // the fused count word: forward count and two-strand total
      int cnt_a = 0, ctot = 0;
      if (use_meta) {
        ++wk.rows;
        if (T.ct16) {
          const uint32_t w = __ldg(T.ct + (key >> 1));
          const uint32_t v = (w >> ((key & 1u) * 16)) & 0xFFFFu;
          cnt_a = v & 0xFF;
          ctot = (v >> 8) & 0xFF;
        } else {
          const uint32_t w = __ldg(T.ct + key);
          cnt_a = w & 0xFFFF;
          ctot = w >> 16;
        }
      }
      const int cnt_b = ctot - cnt_a;
      const bool k_heavy = use_meta && ctot > T.cmax;
      const bool k_empty = use_meta && ctot == 0;
      bool fb_new = !park && k_heavy;
      const bool start_a = use_meta && !k_heavy && !k_empty && cnt_a >= 1;
      const bool skip_to_b =
          use_meta && !k_heavy && !k_empty && cnt_a == 0;
      const bool a_single = start_a && cnt_a == 1;
      const bool a_multi = start_a && cnt_a >= 2;
      const bool b_single = is_keyb && L.cntb == 1;
      const bool b_multi = is_keyb && L.cntb >= 2;
      uint32_t aux_g = 0;
      if (start_a || is_keyb) {
        ++wk.rows;
        aux_g = __ldg(T.aux + clampv((long long)(is_key ? (int)key : L.keyb),
                                     0LL, T.n_aux - 1));
      }
      const bool chain_multi = a_multi || b_multi;

      // the occurrence this round verifies
      int lo_eff = 0, bhi_eff = 0, mid_eff = 0, occ_i_eff;
      bool is_linb = false;
      uint32_t occ_eff;
      if (T.sorted_b) {
        // binary probes: a bucket start probes its middle entry, a POS
        // round mid = (lo + hi) / 2; right compares index the bucket
        // directly, left compares through lperm (right-order-only tables
        // scan orientation B linearly)
        lo_eff = (is_key || is_keyb) ? 0 : L.occ_i;
        bhi_eff = start_a ? cnt_a : is_keyb ? L.cntb : L.bhi;
        mid_eff = (lo_eff + bhi_eff) >> 1;
        const uint32_t aux_for = (is_key || is_keyb) ? aux_g : L.aux;
        int sel = mid_eff;
        if (T.ronly) {
          is_linb = on_b || is_keyb;
          if (is_linb) sel = lo_eff;
        } else if (b_multi || (is_pos && L.strand == 1)) {
          ++wk.rows;
          const uint32_t lslot = aux_for + (uint32_t)mid_eff;
          if (T.l16) {
            const uint32_t lw = __ldg(T.lperm + clampv(
                (long long)(lslot >> 1), 0LL, T.nlperm - 1));
            sel = (lw >> ((lslot & 1u) * 16)) & 0xFFFFu;
          } else {
            const uint32_t lw = __ldg(T.lperm + clampv(
                (long long)(lslot >> 2), 0LL, T.nlperm - 1));
            sel = (lw >> ((lslot & 3u) * 8)) & 0xFFu;
          }
        }
        const bool want_probe = a_multi || b_multi || is_pos;
        uint32_t occ_probe = 0;
        if (want_probe) {
          ++wk.rows;
          occ_probe = pair_at(T, aux_for + (uint32_t)sel);
        }
        occ_eff = (a_single || b_single) ? aux_g
                  : want_probe ? occ_probe : L.occ_pos;
        occ_i_eff = lo_eff;
      } else {
        uint32_t occ0 = 0, occ_row = 0;
        if (chain_multi) {
          ++wk.rows;
          occ0 = pair_at(T, aux_g);
        }
        if (is_pos) {
          ++wk.rows;
          occ_row = pair_at(T, L.aux + (uint32_t)L.occ_i);
        }
        occ_eff = (a_single || b_single) ? aux_g
                  : chain_multi ? occ0 : is_pos ? occ_row : L.occ_pos;
        occ_i_eff = (is_key || is_keyb) ? 0 : L.occ_i;
      }
      const bool ver_like = is_ver || a_single || a_multi || b_single
                            || b_multi || is_pos;
      const int cnt_eff = start_a ? cnt_a : is_keyb ? L.cntb : L.cnt;
      const int best_eff = is_key ? 0 : L.best;
      const uint32_t aux_eff = (is_key || is_keyb) ? aux_g : L.aux;
      const bool on_b_eff = on_b || is_keyb;
      const bool left_cmp = ver_like && on_b_eff;
      const int cmp_off = is_key ? col_a + k : col_a;

      // pair verify: screening rounds (ext == 0) of a linear scan verify
      // two candidates against the same read span
      int j2 = occ_i_eff;
      bool pair_ok = false;
      uint32_t occ_2nd = 0;
      if (!T.sorted_b || T.ronly) {
        j2 = occ_i_eff + 1;
        pair_ok = ver_like && ext_eff == 0 && j2 < cnt_eff
                  && !(a_single || b_single) && (!T.ronly || is_linb);
        if (pair_ok) {
          ++wk.rows;
          occ_2nd = pair_at(T, aux_eff + (uint32_t)j2);
        }
      }
      const int vcap = maxlen - k;
      Cmp c1{0, false, false, false}, c2{0, false, false, false};
      if (ver_like)
        c1 = compare(T, R, side, rowbase, cmp_off, left_cmp, occ_eff,
                     ext_eff, vcap, wk);
      if (pair_ok)
        c2 = compare(T, R, side, rowbase, cmp_off, left_cmp, occ_2nd, 0,
                     vcap, wk);
      if (c1.row_bad || c2.row_bad) fb_new = true;

      int best_new = (ver_like && !c1.survive) ? max(best_eff, c1.ext_after)
                                                : best_eff;
      bool early, cont_occ, cont_from2 = false, occ_done, more_occ;
      int occ_i2, bhi2 = L.bhi, llcp2 = L.llcp, rlcp2 = L.rlcp;
      if (T.sorted_b) {
        // a finished probe moves the bracket [lo, hi) by its order bit;
        // its mismatch offset is the new fence LCP on that side
        if (T.ronly && pair_ok && !c2.survive)
          best_new = max(best_new, c2.ext_after);
        early = best_new >= vcap;
        const bool done1 = ver_like && !c1.survive;
        const int lo2 = (done1 && c1.lt) ? mid_eff + 1 : lo_eff;
        const int hi2 = (done1 && !c1.lt) ? mid_eff : bhi_eff;
        const bool probe_ctx = T.ronly ? ver_like && !is_linb : ver_like;
        const int llcp_eff = (is_key || is_keyb) ? 0 : L.llcp;
        const int rlcp_eff = (is_key || is_keyb) ? 0 : L.rlcp;
        llcp2 = (done1 && probe_ctx && c1.lt) ? c1.ext_after : llcp_eff;
        rlcp2 = (done1 && probe_ctx && !c1.lt) ? c1.ext_after : rlcp_eff;
        if (T.ronly) {
          const bool cont_a = ver_like && !is_linb && !early && c1.survive;
          const bool cont_b = ver_like && is_linb && !early
                              && (c1.survive || (pair_ok && c2.survive));
          cont_occ = cont_a || cont_b;
          cont_from2 = is_linb && !c1.survive && pair_ok && c2.survive;
          occ_done = ver_like && !cont_occ;
          const int next_i = occ_i_eff + (pair_ok ? 2 : 1);
          more_occ = (occ_done && !is_linb && lo2 < hi2 && !early)
                     || (occ_done && is_linb && next_i < cnt_eff && !early);
          if (ver_like && is_linb)
            occ_i2 = (occ_done && next_i < cnt_eff && !early) ? next_i
                     : cont_from2 ? j2 : occ_i_eff;
          else
            occ_i2 = ver_like ? lo2 : occ_i_eff;
          bhi2 = (ver_like && !is_linb) ? hi2 : bhi_eff;
        } else {
          cont_occ = ver_like && !early && c1.survive;
          occ_done = ver_like && !cont_occ;
          more_occ = occ_done && lo2 < hi2 && !early;
          occ_i2 = ver_like ? lo2 : occ_i_eff;
          bhi2 = ver_like ? hi2 : bhi_eff;
        }
      } else {
        if (pair_ok && !c2.survive) best_new = max(best_new, c2.ext_after);
        early = best_new >= vcap;
        cont_occ = ver_like && !early && (c1.survive
                                          || (pair_ok && c2.survive));
        cont_from2 = !c1.survive && pair_ok && c2.survive;
        occ_done = ver_like && !cont_occ;
        const int next_i = occ_i_eff + (pair_ok ? 2 : 1);
        more_occ = occ_done && next_i < cnt_eff && !early;
        occ_i2 = more_occ ? next_i : cont_from2 ? j2 : occ_i_eff;
      }
      // orientation handoff: A exhausted and B has occurrences
      const int cntb_eff = is_key ? cnt_b : L.cntb;
      const bool to_b = (occ_done && !more_occ && L.strand == 0 && !on_b_eff
                         && cntb_eff >= 1 && !early) || skip_to_b;
      const bool ver_resolve = occ_done && !more_occ && !to_b;

      // SUB: two-strand presence bit of the subj-prefix; down one level
      // when absent
      bool sub_present = false, sub_floor = false;
      int subj_next = L.subj;
      if (is_sub) {
        ++wk.rows;
        const uint32_t key_j =
            (uint32_t)L.key >> (2 * (k - clampv(L.subj, 1, k)));
        const uint32_t w_idx = key_j >> 5;
        const long long bm_row = clampv(
            (long long)T.bm_bases[clampv(L.subj, 0, k - 1)] + (w_idx >> 1),
            0LL, T.nbms - 1);
        const uint32_t bm_word = __ldg(T.bms + 2 * (size_t)bm_row
                                       + (w_idx & 1u));
        sub_present = (bm_word >> (key_j & 31u)) & 1u;
        if (!sub_present) {
          subj_next = L.subj - 1;
          sub_floor = subj_next <= j0;
        }
      }

      // the phase's matching statistic, when this round resolves it
      int m_res = floor_case ? maxlen
                  : sub_present ? L.subj : sub_floor ? j0 : k + best_new;
      bool resolve = floor_case || sub_present || sub_floor || ver_resolve;
      if (is_res) {                 // a host-resolved heavy phase
        m_res = L.inj_m;
        resolve = true;
      }
      // BWD: m == maxlen -> the whole prefix occurs, lane done; else go
      // FWD at anc - m. FWD: emit (anc, m + 1) and restart.
      const bool b_res = resolve && is_b;
      const bool prefix_match = b_res && m_res == maxlen;
      const bool to_fwd = b_res && !prefix_match;
      const bool emit = resolve && !is_b;
      if (emit) {
        if (L.nsfs < cap) {
          oq[L.nsfs] = L.anc;
          ol[L.nsfs] = m_res + 1;
        }
        ++L.nsfs;
      }
      const bool emit_done = emit && L.anc == 0;
      const bool restart = emit && !emit_done;

      if (prefix_match || emit_done) L.active = false;
      if (fb_new) L.fb = true;
      int mode2 = (to_fwd || restart) ? KEY : mode;
      if (k_empty || to_sub_short) mode2 = SUB;
      if (cont_occ) mode2 = VER;
      if (more_occ) mode2 = POS;
      if (to_b) mode2 = KEYB;
      if (park && k_heavy) mode2 = PARKED;
      L.mode = mode2;
      const int anc_restart =
          overlap == 0 ? L.anc - 1 : L.anc + m_res + overlap;
      L.anc = to_fwd ? L.anc - m_res : restart ? anc_restart : L.anc;
      L.dirb = to_fwd ? 0 : restart ? 1 : L.dirb;
      L.strand = (to_fwd || restart) ? 0 : to_b ? 1 : L.strand;
      if (is_key) {
        L.key = (int)key;
        L.keyb = (int)keyb_new;
        L.cntb = cnt_b;
      }
      L.subj = k_empty ? k - 1 : to_sub_short ? maxlen : subj_next;
      L.cnt = cnt_eff;
      L.aux = aux_eff;
      L.occ_i = occ_i2;
      L.bhi = bhi2;
      L.llcp = llcp2;
      L.rlcp = rlcp2;
      if (cont_occ) {
        L.occ_pos = cont_from2 ? occ_2nd : occ_eff;
        L.ext = cont_from2 ? c2.ext_after : c1.ext_after;
      } else if (ver_like || is_key || is_keyb) {
        L.ext = 0;
      }
      L.best = ver_like ? best_new : is_key ? 0 : L.best;
    }
    // end of a block of 8: a lane past cap is redone on the host
    if (L.nsfs > cap) L.overflow = true;
    if (L.overflow) L.active = false;
    L.nsfs = min(L.nsfs, cap);
  }
  return r;
}

__global__ void __launch_bounds__(THREADS)
anchor_wide_kernel(Tables T, const uint8_t* __restrict__ seqs,
                   const int32_t* __restrict__ lens, int Q, int Lp1, int cap,
                   int max_rounds, int overlap, int park, int r0,
                   int32_t* __restrict__ state, int32_t* __restrict__ out_qs,
                   int32_t* __restrict__ out_l, int32_t* __restrict__ rounds,
                   unsigned long long* __restrict__ work) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= Q) return;
  int32_t* st = state + lane;
  auto get = [&](int f) { return st[(size_t)f * Q]; };
  Lane L;
  L.active = get(S_ACTIVE) != 0;
  L.fb = get(S_FB) != 0;
  L.overflow = get(S_OVERFLOW) != 0;
  L.dirb = get(S_DIRB);
  L.mode = get(S_MODE);
  L.anc = get(S_ANC);
  L.strand = get(S_STRAND);
  L.key = get(S_KEY);
  L.keyb = get(S_KEYB);
  L.cntb = get(S_CNTB);
  L.subj = get(S_SUBJ);
  L.cnt = get(S_CNT);
  L.aux = (uint32_t)get(S_AUX);
  L.occ_i = get(S_OCC_I);
  L.bhi = get(S_BHI);
  L.llcp = get(S_LLCP);
  L.rlcp = get(S_RLCP);
  L.inj_m = get(S_INJ_M);
  L.occ_pos = (uint32_t)get(S_OCC_POS);
  L.ext = get(S_EXT);
  L.best = get(S_BEST);
  L.nsfs = get(S_NSFS);
  const int nwm = 2 * ((Lp1 + 255) / 256 + 1) - 1;
  const Read R{seqs + (size_t)lane * Lp1, lens[lane], 256 * (nwm + 1)};
  Work wk;
  const int r_end =
      run_lane(T, R, nwm, cap, max_rounds, overlap, park != 0, r0, L,
               out_qs + (size_t)lane * cap, out_l + (size_t)lane * cap, wk);
  auto put = [&](int f, int v) { st[(size_t)f * Q] = v; };
  put(S_ACTIVE, L.active);
  put(S_FB, L.fb);
  put(S_OVERFLOW, L.overflow);
  put(S_DIRB, L.dirb);
  put(S_MODE, L.mode);
  put(S_ANC, L.anc);
  put(S_STRAND, L.strand);
  put(S_KEY, L.key);
  put(S_KEYB, L.keyb);
  put(S_CNTB, L.cntb);
  put(S_SUBJ, L.subj);
  put(S_CNT, L.cnt);
  put(S_AUX, (int)L.aux);
  put(S_OCC_I, L.occ_i);
  put(S_BHI, L.bhi);
  put(S_LLCP, L.llcp);
  put(S_RLCP, L.rlcp);
  put(S_INJ_M, L.inj_m);
  put(S_OCC_POS, (int)L.occ_pos);
  put(S_EXT, L.ext);
  put(S_BEST, L.best);
  put(S_NSFS, L.nsfs);
  atomicMax(rounds, r_end);
  if (work) {
    atomicAdd(work + 0, wk.rounds);
    atomicAdd(work + 1, wk.rows);
    atomicAdd(work + 2, wk.text);
    atomicAdd(work + 3, wk.syms);
  }
}

}  // namespace

// tables: host array of the 7 device table pointers (ct, aux, pospairs,
// bms, text2, badrow, lperm); dims: host int64[32] = their leading sizes,
// then k, j0, cmax, sorted_b, l16, right_only, ct16, then bm_bases[16]
// by level. seqs [Q, Lp1] uint8, lens [Q] int32; state [22, Q] int32 (read
// and written back); out_qs/out_l [Q, cap] int32 (emissions written past
// each lane's n_sfs); rounds [1] int32, set to r0 by the caller, ends as the
// last lane's stop round; work uint64 [4] or null (added to).
extern "C" int svdss_anchor_wide(const void* tables, const void* dims,
                                 const void* seqs, const void* lens, int Q,
                                 int Lp1, int cap, int max_rounds,
                                 int overlap, int park, int r0, void* state,
                                 void* out_qs, void* out_l, void* rounds,
                                 void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t* tp = static_cast<const uint64_t*>(tables);
  const long long* d = static_cast<const long long*>(dims);
  Tables T;
  T.ct = reinterpret_cast<const uint32_t*>(tp[0]);
  T.aux = reinterpret_cast<const uint32_t*>(tp[1]);
  T.pospairs = reinterpret_cast<const uint32_t*>(tp[2]);
  T.bms = reinterpret_cast<const uint32_t*>(tp[3]);
  T.text2 = reinterpret_cast<const uint32_t*>(tp[4]);
  T.badrow = reinterpret_cast<const uint32_t*>(tp[5]);
  T.lperm = reinterpret_cast<const uint32_t*>(tp[6]);
  T.n_ct = d[0];
  T.n_aux = d[1];
  T.npp = d[2];
  T.nbms = d[3];
  T.nrow = d[4];
  T.nbad = d[5];
  T.nlperm = d[6];
  T.k = (int)d[7];
  T.j0 = (int)d[8];
  T.cmax = (int)d[9];
  T.sorted_b = d[10] != 0;
  T.l16 = d[11] != 0;
  T.ronly = d[12] != 0;
  T.ct16 = d[13] != 0;
  for (int j = 0; j < 16; ++j) T.bm_bases[j] = (int)d[14 + j];
  if (Q > 0) {
    anchor_wide_kernel<<<(Q + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        T, static_cast<const uint8_t*>(seqs),
        static_cast<const int32_t*>(lens), Q, Lp1, cap, max_rounds, overlap,
        park, r0, static_cast<int32_t*>(state),
        static_cast<int32_t*>(out_qs), static_cast<int32_t*>(out_l),
        static_cast<int32_t*>(rounds),
        static_cast<unsigned long long*>(work));
  }
  return static_cast<int>(cudaGetLastError());
}
