// Kernels K3 (anchor_batch) and K4 (anchor_pool): the narrow anchor-verify
// SFS search, one warp per read, both driving one lane machine.
//
// K3 replaces svdss_tpu/ops/anchor_jax.py:646 batch_search_anchor (an XLA
// lockstep while-loop over the round body _make_round_body :294, with the
// emission merge _merge_stage :611 every 8 rounds). K4 replaces the
// persistent-lane pool's three XLA functions, svdss_tpu/ops/anchor_pool.py
// :114 step (rounds, then retire and refill on the device), :200 push
// (reads into the device reservoir) and :232 fetch (results out of the
// ring): here one launch takes a chunk of reads, and each warp takes the
// next read from an atomic counter the moment it finishes one.
//
// Results equal the JAX functions' field for field: qs/length in emission
// order, n_sfs = min(count, cap), overflow checked every 8 of a lane's own
// rounds (an overflowed lane finishes its block of 8), incomplete = a
// fallback flag (non-ACGT key window, k-mer above cmax, round budget) or
// still running at max_rounds, iters = the round at which the last lane
// stopped. The round counts, and with them which lanes are incomplete,
// follow the TPU's data layout: a VER round compares at most
// 128 - max(cmp_off, col_t) symbols, where cmp_off comes from the 128-symbol
// read row (stride 64) the round would have gathered and col_t from the
// text row. The kernel never builds those rows; it computes their offsets
// from the padded width Lp1 and reads symbols straight from the read and
// the text.
//
// What bounds it on an H100: a lane is a serial chain of rounds. Each KEY,
// SUB and POS round makes one dependent read of a 16-byte row at a
// data-dependent address of the `small` table (4^k meta rows: 4.3 GB at
// k = 14, far past the 50 MB L2, so a DRAM round trip, often with a TLB
// miss), and a verify round then reads text words at an address that row
// gave. The bytes and operations a round needs are few (one table row, one
// text row, up to 128 compares), so a launch takes as long as its slowest
// read's chain of dependent loads: the kernel is bound by memory latency,
// not by bytes or operations.
//
// What the design does about it: it keeps each round's own work off that
// chain. The 32 threads of a warp hold one read's lane state as
// warp-uniform registers, so every branch of the machine (mode, strand,
// the block of 8 rounds) is taken by the whole warp. KEY builds the k-mer
// in one step: thread i < k loads key digit i, one ballot gives the valid
// digits and one OR-reduction the key. VER compares up to 128 symbols in
// one step, four a thread, the text from its nibble words (one word load
// for 8 symbols), and one min-reduction gives the first mismatch. A
// thread's read symbols for the compare are loaded before the round's
// table row, which they do not depend on, so only the row and the text
// stay on the chain. Thread 0 writes the emissions and the per-read
// results; the warp zeroes the rest of the [cap] rows. K4's warps take the
// next read from an atomic counter; K3's warp w runs lane w.
//
// What is left: one dependent table-row read (and, on a verify, a text
// read behind it) per round, times the slowest read's rounds. Only more
// reads in flight hide that latency, and a launch has at most
// min(lanes, reads) warps, all resident on the card's 132 SMs at the main
// path's sizes. The TPU's row gathers (derive_chunks), funnel shift,
// [Q, 8] emission staging, flip-after-pad RC buffer and the pool's
// reservoir and result ring are gone: a thread derives an RC symbol as
// 5 - P[len-1-x] for 1..4, and emissions go straight to [Q, cap] while the
// index is below cap.
//
// Launch shape: WARPS warps (reads) a block, fixed here; a K3 grid covers
// its Q lanes, a K4 grid min(lanes, M) warps. It depends on no property of
// the card.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPAN = 128;        // symbols per read or text row
constexpr int STAGE_EVERY = 8;   // rounds between overflow checks
constexpr int WARP = 32;
constexpr int WARPS = 4;         // reads (warps) per block
constexpr int THREADS = WARPS * WARP;
constexpr int PER_THREAD = SPAN / WARP;   // compared symbols per thread
constexpr unsigned FULL = 0xffffffffu;
enum { KEY = 0, SUB = 1, POS = 2, VER = 3 };

struct Tables {
  const int4* small;       // [X, 4] int32
  long long X;
  const uint32_t* text;    // [nrow, 16] nibble-packed rows of 128 symbols
  int nrow;
  int n;
  int k, j0, cmax, pos_base;
  int bm_bases[16];        // first bitmap row of level j (0 for j <= j0)
};

struct LaneEnd {
  int count;               // emissions, uncapped
  int rounds;              // rounds run
  bool overflow, fb, active;
};

struct Work {
  unsigned long long rounds = 0, rows = 0, text = 0, syms = 0;
};

__device__ __forceinline__ int comp6(int c) {
  return (c >= 1 && c <= 4) ? 5 - c : c;
}

// Symbol at packed position y of one side of a read in the JAX layout:
// side 0 is the read zero-padded to w8 symbols, side 1 the complement of
// that buffer reversed. P holds plen symbols (zero past them).
__device__ __forceinline__ int read_sym(const uint8_t* P, int plen, int side,
                                        int w8, int y) {
  if (side == 0) return (y >= 0 && y < plen) ? __ldg(P + y) : 0;
  const int j = w8 - 1 - y;
  return (j >= 0 && j < plen) ? comp6(__ldg(P + j)) : 0;
}

// The 32-bit text word that holds position p (0 <= p < n): row p >> 6
// holds the 128 symbols from 64 * (p >> 6), 8 to a word.
__device__ __forceinline__ uint32_t text_word(const Tables& T, int p) {
  return __ldg(T.text + (size_t)(p >> 6) * 16 + ((p & 63) >> 3));
}

// The PER_THREAD text symbols at p, p + 1, ..., zero outside [0, n). Two
// words hold them: the one at p and the one at p + PER_THREAD - 1, each
// clamped into the text so that no load leaves it.
__device__ __forceinline__ void text_syms(const Tables& T, int p, int* ts) {
  const int pa = min(max(p, 0), T.n - 1);
  const int pb = min(max(p + PER_THREAD - 1, 0), T.n - 1);
  const uint32_t wa = text_word(T, pa), wb = text_word(T, pb);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int q = p + i;
    const uint32_t w = (q >> 3) == (pa >> 3) ? wa : wb;
    ts[i] = (q >= 0 && q < T.n) ? (w >> (4 * (q & 7))) & 0xF : 0;
  }
}

__device__ __forceinline__ int quad(int a, int b, int c, int d, int sel) {
  const int lo = (sel & 1) ? b : a;
  const int hi = (sel & 1) ? d : c;
  return (sel & 2) ? hi : lo;
}

// One lane from its reset state to its end, run by the whole warp (t is
// the thread's index in it): rounds in blocks of 8, with the overflow
// check after each block. Every value but a thread's symbols and its
// compare is the same in all 32 threads. A lane whose read is shorter
// than 1 does nothing. budget_on adds the per-lane budget: a lane still
// running in its round number `budget` is flagged for the host (the
// pool's rule). Thread 0 writes the emissions.
__device__ LaneEnd run_lane(const Tables& T, const uint8_t* P, int plen,
                            int len, int nwm, int cap, int max_rounds,
                            bool budget_on, int budget, int overlap,
                            int32_t* oq, int32_t* ol, Work& wk, int t) {
  const int k = T.k, j0 = T.j0;
  const int w8 = 64 * (nwm + 1);
  bool active = len >= 1, fb = false, overflow = false;
  int dirb = 1, mode = KEY, anc = len - 1;
  int key = 0, subj = 0, cnt = 0, aux = 0, occ_i = 0, prow = -1;
  int p0 = 0, p1 = 0, p2 = 0, p3 = 0, occ1c = 0, occ_pos = 0, ext = 0;
  int best = 0, count = 0, r = 0;

  while (active && !fb && r < max_rounds) {
    const int blk_end = r + STAGE_EVERY;
    while (active && !fb && r < max_rounds && r < blk_end) {
      ++r;
      ++wk.rounds;
      const bool is_b = dirb == 1;
      const int u = is_b ? len - 1 - anc : anc;
      const int maxlen = is_b ? anc + 1 : len - anc;
      const int mk = min(k, maxlen);
      const bool is_key = mode == KEY, is_sub = mode == SUB;
      const bool is_pos = mode == POS, is_ver = mode == VER;

      // the read row the round reads: KEY lanes at u, VER lanes at
      // u + k + ext, forward on the working side (RC offset w8 - len)
      int rstart = is_ver ? u + k + ext : u;
      if (is_b) rstart += w8 - len;
      const int m_r = min(max(rstart >> 6, 0), nwm - 1);
      const int col_a = rstart - (m_r << 6);
      const int ybase = m_r << 6;
      // chained lanes read their row at u: compare from k symbols in
      const int cmp_off = is_ver ? col_a : col_a + k;

      // this thread's read symbols of a verify (row columns cmp_off + 4t
      // onwards), loaded ahead of the table row, which they do not need
      int rs[PER_THREAD] = {};
      if (!is_sub) {
        const int y = ybase + cmp_off + PER_THREAD * t;
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i)
          rs[i] = read_sym(P, plen, dirb, w8, y + i);
      }

      // KEY: thread i < k holds key digit i, the symbol at col_a + i
      int key_new = 0;
      bool clean = false, floor_case = false, use_meta = false;
      bool to_sub_short = false, fb_new = false;
      if (is_key) {
        int sym = 0;
        if (t < k) {
          const int c = col_a + t;
          sym = (c >= 0 && c < SPAN) ? read_sym(P, plen, dirb, w8, ybase + c)
                                     : 0;
        }
        const int validm = (int)__ballot_sync(
            FULL, t < k && sym >= 1 && sym <= 4);
        key_new = (int)__reduce_or_sync(
            FULL, t < k ? (unsigned)min(max(sym - 1, 0), 3)
                              << (2 * (k - 1 - t))
                        : 0u);
        const int need = (1 << min(max(mk, 0), 30)) - 1;
        clean = (validm & need) == need;
        floor_case = maxlen <= j0;
        fb_new = !clean;
        use_meta = clean && maxlen >= k;
        to_sub_short = clean && maxlen > j0 && maxlen < k;
      }

      // one small-table row: meta (KEY), bitmap words (SUB) or four
      // positions (POS); one address for the whole warp
      const int key_j =
          (int)((unsigned)key >> (2 * (k - min(max(subj, 1), k))));
      const int w_idx = (int)((unsigned)key_j >> 5);
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      if (use_meta || is_sub || is_pos) {
        long long idx =
            use_meta ? key_new
            : is_sub ? T.bm_bases[min(max(subj, 0), k - 1)] + (w_idx >> 2)
                     : T.pos_base + ((aux + occ_i) >> 2);
        idx = min(max(idx, 0LL), T.X - 1);
        const int4 row = __ldg(T.small + idx);
        s0 = row.x; s1 = row.y; s2 = row.z; s3 = row.w;
        ++wk.rows;
      }

      // KEY dispatch from the meta row
      const bool k_empty = use_meta && s0 == 0;
      const bool k_single = use_meta && s0 == 1;
      const bool k_multi = use_meta && s0 >= 2 && s0 <= T.cmax;
      if (use_meta && s0 > T.cmax) fb_new = true;
      const bool ke_present = k_empty && s2 == 1;
      const bool ke_floor = k - 2 <= j0 && k_empty && s2 == 0;
      const bool ke_cont = k - 2 > j0 && k_empty && s2 == 0;

      const bool pos_take = is_pos;
      const int occ_from_row = quad(s0, s1, s2, s3, aux + occ_i);
      const bool ver_like = is_ver || k_single || k_multi || pos_take;
      const int occ_eff = k_single ? s1 : k_multi ? s2
                          : pos_take ? occ_from_row : occ_pos;
      const int ext_eff = is_ver ? ext : 0;
      const int occ_i_eff = is_key ? 0 : occ_i;
      const int cnt_eff = use_meta ? s0 : cnt;
      const int best_eff = is_key ? 0 : best;
      const int aux_eff = use_meta ? s1 : aux;
      const int prow_eff = k_multi ? -1 : pos_take ? (aux + occ_i) >> 2 : prow;
      if (pos_take) { p0 = s0; p1 = s1; p2 = s2; p3 = s3; }
      if (k_multi) occ1c = s3;

      // verify: compare read and text from cmp_off / tstart; a round runs
      // at most to the end of either 128-symbol row (run_valid) and to the
      // read's end (run_cap); longer matches continue as VER rounds.
      // Thread t compares positions 4t .. 4t + 3; the first mismatch is
      // the least over the warp.
      const int vcap = maxlen - k;
      bool cont_occ = false, more_occ = false, ver_resolve = false;
      bool cached = false;
      int ext_new = 0, best_new = best_eff, occ_i2 = occ_i_eff;
      int occ_from_cache = 0;
      if (ver_like) {
        const int tstart = occ_eff + k + ext_eff;
        const int tr = min(max(tstart >> 6, 0), T.nrow - 1);
        const int col_t = tstart - (tr << 6);
        const int run_valid = SPAN - max(cmp_off, col_t);
        const int run_cap = vcap - ext_eff;
        const int lim = min(run_valid, run_cap);
        int f = lim;
        if (lim > 0) {
          const int d0 = PER_THREAD * t;
          int mine = SPAN;
          if (d0 < lim) {
            int ts[PER_THREAD];
            text_syms(T, tstart + d0, ts);
#pragma unroll
            for (int i = PER_THREAD - 1; i >= 0; --i)
              if (d0 + i < lim && rs[i] != ts[i]) mine = d0 + i;
          }
          f = min(__reduce_min_sync(FULL, mine), lim);
          wk.syms += f < lim ? f + 1 : lim;
        }
        ++wk.text;
        ext_new = ext_eff + max(f, 0);
        cont_occ = f >= run_valid && ext_new < vcap;
        if (!cont_occ) {
          best_new = max(best_eff, ext_new);
          more_occ = occ_i_eff + 1 < cnt_eff && best_new < vcap;
          ver_resolve = !more_occ;
        }
        if (more_occ) {
          // next occurrence: occ 1 inline, else the cached row of four
          occ_i2 = occ_i_eff + 1;
          const bool from_inline = occ_i2 == 1;
          cached = from_inline || ((aux_eff + occ_i2) >> 2) == prow_eff;
          occ_from_cache = from_inline ? occ1c
                                       : quad(p0, p1, p2, p3, aux_eff + occ_i2);
        }
      }

      // SUB: presence bit of the j-mer; down one level when absent
      bool sub_present = false, sub_floor = false;
      int subj_next = subj;
      if (is_sub) {
        const int bm_word = quad(s0, s1, s2, s3, w_idx);
        sub_present = ((unsigned)bm_word >> (key_j & 31)) & 1u;
        if (!sub_present) {
          subj_next = subj - 1;
          sub_floor = subj_next <= j0;
        }
      }

      // the phase's matching statistic m, when this round resolves it
      int m_res = (floor_case && clean) ? maxlen
                  : sub_present ? subj : sub_floor ? j0 : k + best_new;
      if (ke_present) m_res = k - 1;
      else if (ke_floor) m_res = j0;
      const bool resolve = (floor_case && clean) || sub_present || sub_floor
                           || ver_resolve || ke_present || ke_floor;

      // BWD: m == maxlen -> the whole prefix occurs, lane done; else go
      // FWD at anc - m. FWD: emit (anc, m + 1) and restart.
      const bool prefix_match = resolve && is_b && m_res == maxlen;
      const bool to_fwd = resolve && is_b && !prefix_match;
      const bool emit = resolve && !is_b;
      if (emit) {
        if (count < cap && t == 0) {
          oq[count] = anc;
          ol[count] = m_res + 1;
        }
        ++count;
      }
      const bool emit_done = emit && anc == 0;
      const bool restart = emit && !emit_done;
      if (budget_on && r >= budget) fb_new = true;

      if (prefix_match || emit_done) active = false;
      if (fb_new) fb = true;
      int mode2 = (to_fwd || restart) ? KEY : mode;
      if (ke_cont || to_sub_short) mode2 = SUB;
      if (cont_occ || (more_occ && cached)) mode2 = VER;
      if (more_occ && !cached) mode2 = POS;
      mode = mode2;
      const int anc_restart = overlap == 0 ? anc - 1 : anc + m_res + overlap;
      anc = to_fwd ? anc - m_res : restart ? anc_restart : anc;
      dirb = to_fwd ? 0 : restart ? 1 : dirb;
      if (is_key) key = key_new;
      subj = ke_cont ? k - 2 : to_sub_short ? maxlen : subj_next;
      if (use_meta) {
        cnt = s0;
        aux = s1;
      }
      occ_i = occ_i2;
      occ_pos = (more_occ && cached) ? occ_from_cache
                : cont_occ ? occ_eff : occ_pos;
      prow = (more_occ && !cached) ? -1 : prow_eff;
      ext = cont_occ ? ext_new : (ver_like || is_key) ? 0 : ext;
      best = ver_like ? best_new : is_key ? 0 : best;
    }
    // end of a block of 8: a lane past cap is redone on the host
    if (count > cap) overflow = true;
    if (overflow) active = false;
  }
  LaneEnd e;
  e.count = count;
  e.rounds = r;
  e.overflow = overflow;
  e.fb = fb;
  e.active = active;
  return e;
}

__device__ __forceinline__ void add_work(unsigned long long* work,
                                         const Work& wk) {
  if (!work) return;
  atomicAdd(work + 0, wk.rounds);
  atomicAdd(work + 1, wk.rows);
  atomicAdd(work + 2, wk.text);
  atomicAdd(work + 3, wk.syms);
}

// The unwritten rest of a lane's [cap] rows, zeroed by the whole warp.
__device__ __forceinline__ void zero_tail(int32_t* oq, int32_t* ol, int n,
                                          int cap, int t) {
  for (int i = n + t; i < cap; i += WARP) {
    oq[i] = 0;
    ol[i] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
anchor_batch_kernel(Tables T, const uint8_t* __restrict__ seqs,
                    const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ budget, int Q, int Lp1,
                    int cap, int max_rounds, int overlap,
                    int32_t* __restrict__ out_qs, int32_t* __restrict__ out_l,
                    int32_t* __restrict__ n_sfs, uint8_t* __restrict__ ovf_o,
                    uint8_t* __restrict__ inc_o, int32_t* __restrict__ iters,
                    unsigned long long* __restrict__ work) {
  const int q = blockIdx.x * WARPS + threadIdx.x / WARP;
  const int t = threadIdx.x % WARP;
  if (q >= Q) return;              // a whole warp
  int32_t* oq = out_qs + (size_t)q * cap;
  int32_t* ol = out_l + (size_t)q * cap;
  Work wk;
  const LaneEnd e = run_lane(
      T, seqs + (size_t)q * Lp1, Lp1, lens[q], (Lp1 + 63) / 64, cap,
      max_rounds, budget != nullptr, budget ? budget[q] : 0, overlap, oq,
      ol, wk, t);
  const int n = min(e.count, cap);
  zero_tail(oq, ol, n, cap, t);
  if (t == 0) {
    n_sfs[q] = n;
    ovf_o[q] = e.overflow;
    inc_o[q] = e.fb || e.active;
    atomicMax(iters, e.rounds);
    add_work(work, wk);
  }
}

__global__ void __launch_bounds__(THREADS)
anchor_pool_kernel(Tables T, const uint8_t* __restrict__ syms,
                   const long long* __restrict__ offs,
                   const int32_t* __restrict__ lens, int M, int nwm, int cap,
                   int overlap, int warps, int32_t* __restrict__ out_qs,
                   int32_t* __restrict__ out_l, int32_t* __restrict__ n_sfs,
                   uint8_t* __restrict__ flags, int* __restrict__ next,
                   unsigned long long* __restrict__ work) {
  const int t = threadIdx.x % WARP;
  if (blockIdx.x * WARPS + threadIdx.x / WARP >= warps) return;
  Work wk;
  for (;;) {
    int i = 0;
    if (t == 0) i = atomicAdd(next, 1);
    i = __shfl_sync(FULL, i, 0);
    if (i >= M) break;
    const int len = lens[i];
    int32_t* oq = out_qs + (size_t)i * cap;
    int32_t* ol = out_l + (size_t)i * cap;
    const LaneEnd e = run_lane(T, syms + offs[i], len, len, nwm, cap,
                               INT_MAX, true, 6 * len + 64, overlap, oq, ol,
                               wk, t);
    const int n = min(e.count, cap);
    zero_tail(oq, ol, n, cap, t);
    if (t == 0) {
      n_sfs[i] = n;
      flags[i] = (e.fb ? 1 : 0) | (e.overflow ? 2 : 0);
    }
  }
  if (t == 0) add_work(work, wk);
}

Tables make_tables(const void* small, long long X, const void* text, int n,
                   int k, int j0, int cmax, int pos_base,
                   const void* bm_bases) {
  Tables T;
  T.small = static_cast<const int4*>(small);
  T.X = X;
  T.text = static_cast<const uint32_t*>(text);
  T.nrow = n / 64 + 1;
  T.n = n;
  T.k = k;
  T.j0 = j0;
  T.cmax = cmax;
  T.pos_base = pos_base;
  const int32_t* bm = static_cast<const int32_t*>(bm_bases);
  for (int j = 0; j < 16; ++j) T.bm_bases[j] = bm[j];
  return T;
}

}  // namespace

// K3: one-shot batch, one warp per lane. seqs [Q, Lp1] uint8, lens [Q]
// int32, budget [Q] int32 or null; outputs qs/length [Q, cap] int32, n_sfs
// [Q] int32, overflow and incomplete [Q] bool, iters [] int32; work uint64
// [4] or null (added to).
extern "C" int svdss_anchor_batch(
    const void* small, long long X, const void* text, int n, int k, int j0,
    int cmax, int pos_base, const void* bm_bases, const void* seqs,
    const void* lens, const void* budget, int Q, int Lp1, int cap,
    int max_rounds, int overlap, void* out_qs, void* out_l, void* n_sfs,
    void* overflow, void* incomplete, void* iters, void* work,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables T = make_tables(small, X, text, n, k, j0, cmax, pos_base,
                               bm_bases);
  cudaMemsetAsync(iters, 0, sizeof(int32_t), s);
  if (Q > 0) {
    anchor_batch_kernel<<<(Q + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        T, static_cast<const uint8_t*>(seqs), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(budget), Q, Lp1, cap, max_rounds, overlap,
        static_cast<int32_t*>(out_qs), static_cast<int32_t*>(out_l),
        static_cast<int32_t*>(n_sfs), static_cast<uint8_t*>(overflow),
        static_cast<uint8_t*>(incomplete), static_cast<int32_t*>(iters),
        static_cast<unsigned long long*>(work));
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: one pool chunk. M reads, read i at syms[offs[i] .. offs[i] + lens[i]),
// searched as reads of a pool of padded width Lp1 by min(lanes, M) warps
// (the reads in flight) that each take the next read from an atomic counter
// (scratch: one int32); outputs qs/length [M, cap] int32, n_sfs [M] int32,
// flags [M] uint8 (1 = host fallback, 2 = overflow); work uint64 [4] or
// null (added to).
extern "C" int svdss_anchor_pool(
    const void* small, long long X, const void* text, int n, int k, int j0,
    int cmax, int pos_base, const void* bm_bases, const void* syms,
    const void* offs, const void* lens, int M, int Lp1, int cap, int overlap,
    int lanes, void* out_qs, void* out_l, void* n_sfs, void* flags,
    void* counter, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables T = make_tables(small, X, text, n, k, j0, cmax, pos_base,
                               bm_bases);
  cudaMemsetAsync(counter, 0, sizeof(int32_t), s);
  const int warps = min(lanes, M);
  if (warps > 0) {
    anchor_pool_kernel<<<(warps + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        T, static_cast<const uint8_t*>(syms),
        static_cast<const long long*>(offs), static_cast<const int32_t*>(lens),
        M, (Lp1 + 63) / 64, cap, overlap, warps,
        static_cast<int32_t*>(out_qs), static_cast<int32_t*>(out_l),
        static_cast<int32_t*>(n_sfs), static_cast<uint8_t*>(flags),
        static_cast<int*>(counter), static_cast<unsigned long long*>(work));
  }
  return static_cast<int>(cudaGetLastError());
}
