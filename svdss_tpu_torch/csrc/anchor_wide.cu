// Kernel K5 (anchor_wide): the wide anchor-verify SFS search over
// forward-strand tables with uint32 coordinates, one warp per read lane,
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
// What bounds it on an H100: each round of a lane makes a chain of
// dependent reads at data-dependent addresses: the fused count word (with
// the aux entry of the same key), sometimes an lperm word, then a poslist
// pair, then the text words and the badrow word at the address that pair
// gave; a SUB round reads one presence-bitmap word. The tables are far
// past the 50 MB L2 (the aux table alone is 1 GiB at k = 14), so each link
// is a DRAM round trip. A lane is a serial chain of such rounds, and a
// launch takes its slowest lane's rounds times that chain: the kernel is
// bound by memory latency, not by bytes or operations (the bytes the work
// must move are those words and the symbols compared).
//
// What the design does about it: it keeps each round's own work off that
// chain. The 32 threads of a warp hold one lane's state as warp-uniform
// registers, so every branch of the machine (mode, strand, orientation,
// park, the block of 8 rounds) is taken by the whole warp. At the start of
// a launch the warp packs its lane's read into 2-bit words in shared
// memory (16 symbols a word); a read symbol window is then two
// shared-memory words and a funnel shift, and one of side 1 (the reverse
// complement) the same window of side 0 bit-reversed and complemented.
// KEY takes the k-mer from one such window (its digits outside the row's
// [0, 512) cut), and what depends on the key alone leaves at once: the
// count word, the key's aux entry and, one level a thread, the bitmap
// words that a SUB cascade from the key reads, so those SUB rounds take
// their word from a shuffle instead of DRAM. A compare covers the row's
// up to 512 distances in one step, 16 a thread (thread t takes distances
// 16t .. 16t + 15): the text symbols come from two 2-bit words a thread
// by a funnel shift (bit-reversed for a leftward compare), the read's
// from the packed read, and one XOR gives the thread's mismatches; one
// min-reduction over (distance, order bit) gives the first mismatch and
// whether the text sorts below the read there. The leftward re-scan of a
// run that reaches the text start is a second reduction over the same
// words, and a pair-verify round runs two compares against the one read
// word. Thread 0 writes the emissions, the lane state back and the round
// and work atomics. Every round runs as one round of the lane machine,
// so the round and work counts are the one-thread design's.
//
// Where the block's packed reads do not fit the shared memory a block may
// opt in to on the card (reads past ~230k symbols), the launch takes the
// same lanes reading the read's bytes instead; the launcher decides.
//
// What is left: one dependent DRAM read a round at least (the count word,
// a bitmap word not fetched ahead, or a bucket's poslist pair), times the
// slowest lane's rounds. Only more lanes in flight hide it, and a launch
// has one warp a lane, all resident at the wide run's sizes. Between
// waves the state stays in the device tensor `state` ([22, Q] int32) that
// a launch reads at entry and writes back at exit.
//
// Launch shape: WARPS warps (lanes) a block; the dynamic shared memory is
// WARPS packed reads of the launch's padded width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPAN2 = 512;       // symbols per span row
constexpr int STAGE_EVERY = 8;   // rounds between overflow checks
constexpr int WARP = 32;
constexpr int WARPS = 4;         // lanes (warps) a block
constexpr int THREADS = WARPS * WARP;
constexpr int PER_THREAD = SPAN2 / WARP;   // compared distances a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned EVEN = 0x55555555u;     // the low bit of each symbol
constexpr int NONE = 1 << 30;              // no mismatch (reductions)
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

// the read: its bytes, its length, the packed side width 256*(nwm+1),
// and (packed lanes) its symbols as 2-bit words in shared memory, 16 a
// word, symbol y in bits 2 (y % 16) of word y / 16; nw words hold the
// read, 0 past them
struct Read {
  const uint8_t* P;
  int len, w16;
  const uint32_t* words;
  int nw;
};

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 2-bit value of read symbol y (nt6 - 1; 0 past the read)
__device__ __forceinline__ int rsym(const Read& R, int y) {
  if (y < 0 || y >= R.len) return 0;
  return clampv((int)__ldg(R.P + y) - 1, 0, 3);
}

// The 16 symbols of a word in reverse order (slot i to slot 15 - i).
__device__ __forceinline__ uint32_t rev16(uint32_t w) {
  w = __brev(w);
  return ((w >> 1) & EVEN) | ((w & EVEN) << 1);
}

// Read symbols y0 .. y0 + 15 in slots 0 .. 15 (0 outside the read): two
// shared-memory words and a funnel shift on a packed lane, else 16 bytes.
template <bool PACKED>
__device__ __forceinline__ uint32_t read16(const Read& R, int y0) {
  if constexpr (PACKED) {
    const int wi = y0 >> 4;          // floor: y0 may be negative
    const uint32_t w0 = (unsigned)wi < (unsigned)R.nw ? R.words[wi] : 0u;
    const uint32_t w1 =
        (unsigned)(wi + 1) < (unsigned)R.nw ? R.words[wi + 1] : 0u;
    return __funnelshift_r(w0, w1, 2 * (y0 & 15));
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      w |= (uint32_t)rsym(R, y0 + i) << (2 * i);
    return w;
  }
}

// Symbols y0 .. y0 + 15 of one side in slots 0 .. 15: side 0 is the read,
// side 1 the complement of the read zero-padded to w16 and reversed, whose
// symbol y is 3 - (read symbol w16 - 1 - y).
template <bool PACKED>
__device__ __forceinline__ uint32_t side16(const Read& R, int side, int y0) {
  return side == 0 ? read16<PACKED>(R, y0)
                   : rev16(read16<PACKED>(R, R.w16 - PER_THREAD - y0)) ^ FULL;
}

// The warp packs its lane's read into R.words (2-bit, 16 a word).
__device__ __forceinline__ void pack_read(const Read& R, uint32_t* words,
                                          int t) {
  for (int w = t; w < R.nw; w += WARP) {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      x |= (uint32_t)rsym(R, PER_THREAD * w + i) << (2 * i);
    words[w] = x;
  }
  __syncwarp();
}

__device__ __forceinline__ uint32_t pair_at(const Tables& T, uint32_t slot) {
  const long long row = clampv((long long)(slot >> 1), 0LL, T.npp - 1);
  return __ldg(T.pospairs + 2 * (size_t)row + (slot & 1u));
}

// The presence-bitmap word that holds level j's bit of key (the word a
// SUB round at subj = j reads).
__device__ __forceinline__ uint32_t bm_word_at(const Tables& T, uint32_t key,
                                               int j) {
  const uint32_t key_j = key >> (2 * (T.k - clampv(j, 1, T.k)));
  const uint32_t w_idx = key_j >> 5;
  const long long bm_row = clampv(
      (long long)T.bm_bases[clampv(j, 0, T.k - 1)] + (w_idx >> 1), 0LL,
      T.nbms - 1);
  return __ldg(T.bms + 2 * (size_t)bm_row + (w_idx & 1u));
}

__device__ __forceinline__ uint32_t rc_key(uint32_t y, int k) {
  y = ((y & 0x33333333u) << 2) | ((y >> 2) & 0x33333333u);
  y = ((y & 0x0F0F0F0Fu) << 4) | ((y >> 4) & 0x0F0F0F0Fu);
  y = ((y & 0x00FF00FFu) << 8) | ((y >> 8) & 0x00FF00FFu);
  y = (y << 16) | (y >> 16);
  y >>= 32 - 2 * k;
  return y ^ ((1u << (2 * k)) - 1u);
}

// The low bit of each 2-bit symbol slot i in [lo, hi) of a thread's word.
__device__ __forceinline__ uint32_t slots(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, PER_THREAD);
  if (hi <= lo) return 0u;
  const uint32_t upto = hi == PER_THREAD ? FULL : (1u << (2 * hi)) - 1u;
  return upto & ~((1u << (2 * lo)) - 1u) & EVEN;
}

// Thread t's part of a compare against the read row (side, rowbase) from
// column cmp_off, rightward or leftward: its read symbols at distances
// 16t + i in slot i of `word`, and in `cols` the slots whose row column
// lies in [0, 512) (the others take no part).
struct ReadPart {
  uint32_t word, cols;
};

template <bool PACKED>
__device__ __forceinline__ ReadPart read_part(const Read& R, int side,
                                              int rowbase, int cmp_off,
                                              bool left, int t) {
  const int c0 = left ? cmp_off - PER_THREAD * t : cmp_off + PER_THREAD * t;
  ReadPart rp;
  rp.cols = left ? slots(c0 - (SPAN2 - 1), c0 + 1) : slots(-c0, SPAN2 - c0);
  rp.word = left ? rev16(side16<PACKED>(R, side,
                                       rowbase + c0 - (PER_THREAD - 1)))
                 : side16<PACKED>(R, side, rowbase + c0);
  return rp;
}

// Thread t's text symbols at distances 16t + i from column col_t of text
// row tr, rightward or leftward, in slot i; 0 outside the row's [0, 512).
// Two row words hold them (one funnel shift); a leftward window is
// bit-reversed into distance order.
__device__ __forceinline__ uint32_t text_part(const Tables& T, long long tr,
                                              int col_t, bool left, int t) {
  const int lo = left ? col_t - PER_THREAD * t - (PER_THREAD - 1)
                      : col_t + PER_THREAD * t;
  const int wi = lo >> 4;          // floor: lo may be negative
  const uint32_t* row = T.text2 + (size_t)tr * (SPAN2 / 16);
  const uint32_t w0 = (wi >= 0 && wi < SPAN2 / 16) ? __ldg(row + wi) : 0u;
  const uint32_t w1 =
      (wi + 1 >= 0 && wi + 1 < SPAN2 / 16) ? __ldg(row + wi + 1) : 0u;
  const uint32_t w = __funnelshift_r(w0, w1, 2 * (lo & 15));
  return left ? rev16(w) : w;
}

// The first distance of a thread's slot mask `m` (NONE when empty), with
// the order bit of the two words there: (16t + i) << 1 | (text < read).
__device__ __forceinline__ int first_key(uint32_t m, uint32_t tw,
                                         uint32_t qw, int t) {
  if (m == 0u) return NONE;
  const int i = (__ffs(m) - 1) >> 1;
  const uint32_t ts = (tw >> (2 * i)) & 3u, qs = (qw >> (2 * i)) & 3u;
  return ((PER_THREAD * t + i) << 1) | (ts < qs ? 1 : 0);
}

struct Cmp {
  int ext_after;
  bool survive, row_bad, lt;
};

// One verify compare of the read row from column cmp_off against
// occurrence occ at extension ext0, rightward or (left) leftward, by the
// whole warp; the anchor_wide_jax.py compare() :595. rp is the thread's
// read part of that row (read_part), the same for every compare of a
// round.
__device__ Cmp compare(const Tables& T, const ReadPart& rp, int cmp_off,
                       bool left, uint32_t occ, int ext0, int vcap, Work& wk,
                       int t) {
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
  // a leftward run with no mismatch within D that may reach the text
  // start scans on to its row's end (below)
  const bool rescan = left && avail32 > 0 && avail32 <= SPAN2 && D < avail32;
  uint32_t tw = 0, mism = 0;
  if (D > 0 || rescan) {
    tw = text_part(T, tr, col_t, left, t);
    const uint32_t x = tw ^ rp.word;
    mism = (x | (x >> 1)) & rp.cols;
  }
  const int d0 = PER_THREAD * t;
  const int key = __reduce_min_sync(
      FULL, first_key(mism & slots(-d0, D - d0), tw, rp.word, t));
  const bool found = key != NONE;
  const int f = key >> 1;
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
    } else if (rescan) {
      const int key2 = __reduce_min_sync(
          FULL, first_key(mism & slots(max(D, 0) - d0, SPAN2 + 1 - d0), tw,
                          rp.word, t));
      hit_start = (key2 != NONE ? key2 >> 1 : SPAN2) >= avail32;
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
  r.lt = hit_start || (found && (key & 1));
  return r;
}

// One lane from round r0 until it ends, parks (park) or reaches
// max_rounds, in blocks of 8 rounds with the overflow check after each,
// run by the whole warp (t is the thread's index in it). Every value but
// a thread's symbols and its part of a compare is the same in all 32
// threads. Thread 0 writes the emissions. Returns the round at which the
// lane stopped.
template <bool PACKED>
__device__ int run_lane(const Tables& T, const Read& R, int nwm, int cap,
                        int max_rounds, int overlap, bool park, int r0,
                        Lane& L, int32_t* oq, int32_t* ol, Work& wk, int t) {
  const int k = T.k, j0 = T.j0;
  const int n_lv = k - 1 - j0;     // bitmap levels j0 + 1 .. k - 1
  // thread i < n_lv: the bitmap word of level j0 + 1 + i of L.key, when
  // bm_ok (fetched by the KEY round that set L.key)
  uint32_t bm_pre = 0;
  bool bm_ok = false;
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

      // a compare reads the row from cmp_off, leftward on orientation B:
      // this thread's read symbols of it, loaded ahead of the table reads,
      // which they do not need
      const bool on_b_eff = on_b || is_keyb;
      const int cmp_off = is_key ? col_a + k : col_a;
      ReadPart rp{0u, 0u};
      if (is_key || is_keyb || is_pos || is_ver)
        rp = read_part<PACKED>(R, side, rowbase, cmp_off, on_b_eff, t);

      // KEY: the k-mer at col_a and its RC key. Digit i is the symbol at
      // row column col_a + i (0 outside [0, 512)): the 16 symbols from
      // col_a, those columns kept, reversed so that digit 0 is the top
      uint32_t key = 0;
      if (is_key) {
        const uint32_t keep = slots(-col_a, SPAN2 - col_a) & slots(0, k);
        key = rev16(side16<PACKED>(R, side, rowbase + col_a) &
                    (keep | keep << 1)) >> (2 * (PER_THREAD - k));
      }
      const uint32_t keyb_new = rc_key(key, k);
      const bool floor_case = is_key && maxlen <= j0;
      const bool use_meta = is_key && maxlen >= k;
      const bool to_sub_short = is_key && maxlen > j0 && maxlen < k;

      // what depends on the key alone leaves at once: the fused count word
      // (forward count and two-strand total), the key's aux entry (read
      // when the k-mer starts a bucket) and, one level a thread, the
      // bitmap words of a SUB cascade from the key
      if (is_key) {
        bm_ok = use_meta || to_sub_short;
        if (bm_ok && t < n_lv) bm_pre = bm_word_at(T, key, j0 + 1 + t);
      }
      int cnt_a = 0, ctot = 0;
      uint32_t aux_key = 0;
      if (use_meta) {
        aux_key = __ldg(T.aux + clampv((long long)(int)key, 0LL,
                                       T.n_aux - 1));
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
        aux_g = is_key ? aux_key
                       : __ldg(T.aux + clampv((long long)L.keyb, 0LL,
                                              T.n_aux - 1));
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
      const bool left_cmp = ver_like && on_b_eff;

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
        c1 = compare(T, rp, cmp_off, left_cmp, occ_eff, ext_eff, vcap, wk,
                     t);
      if (pair_ok)
        c2 = compare(T, rp, cmp_off, left_cmp, occ_2nd, 0, vcap, wk, t);
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
        const int lv = L.subj - j0 - 1;
        const uint32_t bm_word =
            bm_ok && lv >= 0 && lv < n_lv
                ? __shfl_sync(FULL, bm_pre, lv)
                : bm_word_at(T, (uint32_t)L.key, L.subj);
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
        if (L.nsfs < cap && t == 0) {
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

// Words of shared memory a packed lane of padded width Lp1 takes.
__host__ __device__ __forceinline__ int lane_words(int Lp1) {
  return (Lp1 + PER_THREAD - 1) / PER_THREAD;
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
anchor_wide_kernel(Tables T, const uint8_t* __restrict__ seqs,
                   const int32_t* __restrict__ lens, int Q, int Lp1, int cap,
                   int max_rounds, int overlap, int park, int r0,
                   int32_t* __restrict__ state, int32_t* __restrict__ out_qs,
                   int32_t* __restrict__ out_l, int32_t* __restrict__ rounds,
                   unsigned long long* __restrict__ work) {
  const int lane = blockIdx.x * WARPS + threadIdx.x / WARP;
  const int t = threadIdx.x % WARP;
  if (lane >= Q) return;             // a whole warp
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
  extern __shared__ uint32_t lane_smem[];
  uint32_t* words = lane_smem + (size_t)(threadIdx.x / WARP) * lane_words(Lp1);
  const int len = lens[lane];
  const Read R{seqs + (size_t)lane * Lp1, len, 256 * (nwm + 1), words,
               (len + PER_THREAD - 1) / PER_THREAD};
  if (PACKED && L.active && !L.fb && !(park && L.mode == PARKED) &&
      r0 < max_rounds)
    pack_read(R, words, t);
  Work wk;
  const int r_end =
      run_lane<PACKED>(T, R, nwm, cap, max_rounds, overlap, park != 0, r0, L,
               out_qs + (size_t)lane * cap, out_l + (size_t)lane * cap, wk,
               t);
  __syncwarp();                      // every thread has read the state
  if (t != 0) return;
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
  if (Q <= 0) return static_cast<int>(cudaGetLastError());
  // the launch: packed lanes where the block's reads fit the shared
  // memory a block may opt in to on this card, else lanes that read the
  // read's bytes
  const size_t smem = (size_t)WARPS * lane_words(Lp1) * sizeof(uint32_t);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool packed = smem <= (size_t)limit;
  if (packed && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(anchor_wide_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* sq = static_cast<const uint8_t*>(seqs);
  const auto* ln = static_cast<const int32_t*>(lens);
  auto* stp = static_cast<int32_t*>(state);
  auto* oq = static_cast<int32_t*>(out_qs);
  auto* ol = static_cast<int32_t*>(out_l);
  auto* rd = static_cast<int32_t*>(rounds);
  auto* wk = static_cast<unsigned long long*>(work);
  const int blocks = (Q + WARPS - 1) / WARPS;
  if (packed)
    anchor_wide_kernel<true><<<blocks, THREADS, smem, s>>>(
        T, sq, ln, Q, Lp1, cap, max_rounds, overlap, park, r0, stp, oq, ol,
        rd, wk);
  else
    anchor_wide_kernel<false><<<blocks, THREADS, 0, s>>>(
        T, sq, ln, Q, Lp1, cap, max_rounds, overlap, park, r0, stp, oq, ol,
        rd, wk);
  return static_cast<int>(cudaGetLastError());
}
