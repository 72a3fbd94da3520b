// Kernel K2 (pingpong_fm): ping-pong SFS search with the FM rank walk, one
// warp per read lane, in two instantiations: narrow (index < 2^31
// symbols, int32 coordinates) and wide (int64 coordinates, the fused rows'
// checkpoints split into a low limb of `limb_bits` bits and a 5-bit high
// limb a symbol in columns 6 and 7; C as int64).
//
// Replaces svdss_tpu/ops/pingpong_jax.py:117 batch_search (an XLA
// lockstep while-loop: step :185, outer body :314; wide branches :156-158,
// :259-262) and the rank step it runs, svdss_tpu/ops/fmd_jax.py:372
// extend_rank_step (wide branch :405-479). Same results, field for field:
// qs/length in emission order, n_sfs = min(count, cap), overflow checked
// every 48 steps, incomplete = still active at the step budget, iters = 48
// x the most 48-step blocks any lane ran. The TPU split every coordinate
// into two int32 limbs (its int64 is emulated); here a coordinate is one
// int64 register and only the table's checkpoints carry limbs. A table past
// 2^31 symbols has more than 16.7M rows, so row offsets are size_t.
//
// What bounds a step on an H100: one dependent read of a 192-byte fused
// row at a data-dependent address (the FM walk), plus the count over its
// 32 packed words and one warp reduction. At chromosome scale the fused
// table (1.5 bytes/symbol, ~120 MB at 80M symbols) is larger than the
// 50 MB L2, so the row is about one device-memory latency; a lane is a
// serial chain of such steps and the kernel is latency-bound, not bandwidth-
// or compute-bound. The bytes the work must move are one row per step.
//
// Why a warp per lane: with one thread a lane, each step also ran the 32
// words' equality masks and 64 popcounts in that one thread, ~1,200 issue
// cycles on the chain (a quarter-SM issues 16 integer lanes a clock but
// only 4 popcount lanes), and 2,304 lanes made 72 warps, at most one an SM.
// Here the 32 threads of a warp hold one lane's state as warp-uniform
// registers, so every branch is taken by the whole warp. Thread t loads
// packed word t of the row (the 32 words are 128 coalesced bytes) and
// threads 0-7 the checkpoint columns, all in one round trip with the
// read's symbol P[a], which the row's address does not depend on; the
// checkpoint of the step's symbol then comes by one shuffle. Thread t
// masks its own word and takes two popcounts, at most 8 each; the two
// are packed in the halves of one word and summed over the warp by one
// __reduce_add_sync. A launch has Q warps, WARPS to a block.
//
// The pending row a step ahead: an interval wider than the row's 256-symbol
// span takes two steps (fmd_jax.extend_rank_step: step A ranks at lo and
// raises `pend`, step B ranks at hi). Both row addresses are known in step
// A, so step A loads the row at hi >> 7 beside the row at lo >> 7 and
// counts both in the one reduction (rank at lo in the low half, rank at hi
// in the high half); step B takes its rank from a register and makes no
// load at all. Step B still counts as a step (iters, the overflow cadence
// and the rank-step counter are unchanged); what it saves is the second
// dependent row latency at the start of every phase. A sentinel step
// (forward past the read's end) ranks at position 0, as the plain version
// does; it is known only from P[a], so it reads row 0's checkpoint apart.
//
// Jump mode (narrow only, jump_k > 0): the k-mer jump-start of
// svdss_tpu/ops/pingpong_jax.py:264-302 (key chunks :145-146, :323-327).
// At a phase transition whose k-mer is present in the table built by kernel
// K6 (csrc/jump.cu), a lane loads that k-mer's bi-interval as one 16-byte
// row (one broadcast load) and skips k - 1 rank steps: going forward it
// takes x1 and ends at begin + k - 1, restarting backward it takes x0 and
// begins at begin_new - (k - 1). The JAX package decides a jump from the
// geometry of its 256-symbol key chunk, whose base 128m is fixed at the
// start of each 48-step block from the lane's cursor; this kernel keeps
// that base per lane, recomputed at every block start, so the same
// transitions jump and the outputs (iters included) are the JAX package's.
// The key of the window ending at kpos is computed from the read itself
// (the JAX package uploads a [Q, L+1] key array): thread i < k loads symbol
// kpos - i, one ballot finds a symbol outside A..T and one OR-reduction
// builds the key; -1 when the window starts before the read or ends past
// the padded read. Past the padded read the JAX package's key chunks hold
// 0, the key of poly-A, and a lane can jump there and leave the host
// oracle; here such a window holds no key and the lane follows the oracle.
//
// Thread 0 writes the emissions, the per-lane results and the atomics; the
// warp zeroes the [cap] tails. The launch shape is fixed here and depends
// on no property of the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K_INNER = 48;   // steps between overflow checks
constexpr int DEV_BLOCK = 128;
constexpr int SPAN = 256;
constexpr int ROW_WORDS = 48;
constexpr int OCC_COLS = 16;
constexpr int WARP = 32;
constexpr int WARPS = 4;      // lanes (warps) per block
constexpr int THREADS = WARPS * WARP;
constexpr int CHUNK = 256;    // the JAX package's per-lane key chunk
constexpr int STRIDE = 128;   // its chunk base granularity
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int comp6(int c) {
  return (c >= 1 && c <= 4) ? 5 - c : c;
}

// bit (8 << 4j) of word w set iff span position 32*j + w < bound
// (bound in [0, 256]); interleaved nibble packing of the fused rows
__device__ __forceinline__ uint32_t nib_mask_lt(int bound, int w) {
  const int k = bound >> 5;
  if (k >= 8) return 0x88888888u;
  const uint32_t full = ((1u << (4 * k)) - 1u) & 0x88888888u;
  return full | (w < (bound & 31) ? (8u << (4 * k)) : 0u);
}

// nibble-equality bits of a packed word with symbol c: symbols and c are
// <= 5, so x's nibbles are <= 7
__device__ __forceinline__ uint32_t nib_eq(uint32_t word, uint32_t cpat) {
  const uint32_t x = word ^ cpat;
  return ~(x + 0x77777777u) & 0x88888888u;
}

// The key of the k-mer of P ending at kpos (sum (sym - 1) * 4^i, the last
// symbol at 4^0), or -1 when the window starts before the read, ends past
// the padded read, or holds a symbol outside A..T. Thread i < k loads
// symbol kpos - i; the result is warp-uniform.
__device__ __forceinline__ int window_key(const uint8_t* P, int Lp1, int kpos,
                                          int k, int t) {
  if (kpos - (k - 1) < 0 || kpos >= Lp1) return -1;
  const int s = t < k ? (int)__ldg(P + kpos - t) : 1;
  const unsigned bad = __ballot_sync(FULL, s < 1 || s > 4);
  const unsigned key =
      __reduce_or_sync(FULL, t < k ? (unsigned)(s - 1) << (2 * t) : 0u);
  return bad ? -1 : (int)key;
}

// Checkpoint count of symbol c in a fused row: the int32 column, or in wide
// mode that low limb joined with the symbol's 5-bit high limb of column 6.
template <bool WIDE>
__device__ __forceinline__ long long occ_at(const int32_t* row, int c,
                                            int limb_bits) {
  const long long lo = __ldg(row + c);
  if (!WIDE) return lo;
  const long long hi = ((uint32_t)__ldg(row + 6) >> (5 * c)) & 31u;
  return lo + (hi << limb_bits);
}

// The same from the row's columns 0-7, held by threads
// 0-7 (ck), by shuffles. Warp-uniform.
template <bool WIDE>
__device__ __forceinline__ long long occ_from(int32_t ck, int c,
                                             int limb_bits) {
  const long long lo = __shfl_sync(FULL, ck, c);
  if (!WIDE) return lo;
  const long long hi =
      ((uint32_t)__shfl_sync(FULL, ck, 6) >> (5 * c)) & 31u;
  return lo + (hi << limb_bits);
}

// Coord is the lane's coordinate type: int (narrow) or long long (wide).
template <typename Coord, bool WIDE>
__global__ void __launch_bounds__(THREADS)
pingpong_fm_kernel(const int32_t* __restrict__ fused,
                   const Coord* __restrict__ Cg,
                   const uint8_t* __restrict__ seqs,
                   const int32_t* __restrict__ lens,
                   const int4* __restrict__ jt,
                   int Q, int Lp1, int cap, int max_outer, int overlap,
                   int limb_bits, int jump_k, int n_windows,
                   int32_t* __restrict__ out_qs, int32_t* __restrict__ out_l,
                   int32_t* __restrict__ n_sfs, uint8_t* __restrict__ ovf_o,
                   uint8_t* __restrict__ inc_o, int32_t* __restrict__ iters,
                   unsigned long long* __restrict__ work,
                   unsigned long long* __restrict__ jump_work) {
  __shared__ Coord C[8];
  if (threadIdx.x < 8) C[threadIdx.x] = Cg[threadIdx.x];
  __syncthreads();
  const int t = threadIdx.x & (WARP - 1);
  const int lane = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (lane >= Q) return;
  const uint8_t* P = seqs + (size_t)lane * Lp1;
  int32_t* oq = out_qs + (size_t)lane * cap;
  int32_t* ol = out_l + (size_t)lane * cap;

  const int len = lens[lane];
  bool active = len >= 1;
  int begin = len - 1, end = 0, dir = 0;   // dir 0 = backward, 1 = forward
  const int c0 = active ? P[begin] : 0;
  Coord pos = C[c0], sz = C[c0 + 1] - C[c0];
  bool pend = false;
  Coord p_rank = 0, p_hi = 0;   // step A's ranks at lo and at hi
  int count = 0, blocks = 0;
  long long rank_steps = 0, jump_rows = 0;
  bool overflow = false;
  const bool jumps = !WIDE && jump_k > 0;
  int base = 0;   // the lane's key-chunk base in jump mode

  while (active && blocks < max_outer) {
    if (jumps) {
      // pingpong_jax.py:316-319, 328: the window around the cursor
      const int cursor = min(max(dir == 0 ? begin : end + 1, 0), Lp1 - 1);
      base = min(max((cursor - STRIDE / 2) >> 7, 0), n_windows - 1) * STRIDE;
    }
    for (int k = 0; k < K_INNER && active; ++k) {
      const bool is_bwd = dir == 0;
      const bool bwd_can = is_bwd && sz != 0 && begin > 0;
      const bool fwd_can = !is_bwd && sz != 0;
      const bool do_ext = bwd_can || fwd_can;
      int a = is_bwd ? (bwd_can ? begin - 1 : begin)
                     : (fwd_can ? end + 1 : end - 1);
      a = max(a, 0);
      // the rows of this step's rank (0-width at position 0 when the lane
      // does not extend), issued with P[a]: their addresses do not depend
      // on the symbol. Step B of a wide interval loads nothing.
      const Coord lo = do_ext ? pos : 0;
      const Coord szm = do_ext ? sz : 0;
      const int off_lo = (int)(lo & (DEV_BLOCK - 1));
      const Coord off_hi = off_lo + szm;
      const Coord hi = lo + szm;
      const bool near = off_hi <= SPAN;
      uint32_t w_lo = 0, w_hi = 0;
      int32_t ck_lo = 0, ck_hi = 0;
      if (!pend) {
        const int32_t* row = fused + (size_t)(lo >> 7) * ROW_WORDS;
        w_lo = (uint32_t)__ldg(row + OCC_COLS + t);
        if (t < 8) ck_lo = __ldg(row + t);
        if (!near) {
          const int32_t* rh = fused + (size_t)(hi >> 7) * ROW_WORDS;
          w_hi = (uint32_t)__ldg(rh + OCC_COLS + t);
          if (t < 8) ck_hi = __ldg(rh + t);
        }
      }
      const int c_acc = a < Lp1 ? (int)__ldg(P + a) : 0;
      const int c_sel = is_bwd ? c_acc : comp6(c_acc);
      // forward extension past the last base reads the NUL sentinel: its
      // interval is forced empty and the step completes at once
      const bool sent = !is_bwd && c_acc == 0;
      const bool do_rank = do_ext && !sent;
      rank_steps += do_rank;

      // rank step (fmd_jax.extend_rank_step)
      bool complete;
      Coord rank_lo, szn;
      if (pend) {
        // step B: the rank at hi came with step A
        complete = true;
        rank_lo = p_rank;
        szn = p_hi - p_rank;
        pend = false;
      } else if (do_rank) {
        const uint32_t cpat = (uint32_t)c_sel * 0x11111111u;
        const uint32_t zm = nib_eq(w_lo, cpat);
        const uint32_t below_lo = nib_mask_lt(off_lo, t);
        const uint32_t n_lo = __popc(zm & below_lo);
        const uint32_t n_hi =
            near ? __popc(zm & nib_mask_lt((int)off_hi, t) & ~below_lo)
                 : __popc(nib_eq(w_hi, cpat)
                          & nib_mask_lt((int)(hi & (DEV_BLOCK - 1)), t));
        const uint32_t s = __reduce_add_sync(FULL, n_lo | (n_hi << 16));
        const Coord anchor = (Coord)occ_from<WIDE>(ck_lo, c_sel, limb_bits)
                             + (Coord)(s & 0xffffu);
        rank_lo = anchor;
        if (near) {
          complete = true;
          szn = (Coord)(s >> 16);
        } else {
          complete = false;
          szn = 0;
          pend = true;
          p_rank = anchor;
          p_hi = (Coord)occ_from<WIDE>(ck_hi, c_sel, limb_bits)
                 + (Coord)(s >> 16);
        }
      } else {
        // a 0-width query at position 0: row 0's checkpoint (the lane
        // applies it only on a sentinel step, where c_sel is 0)
        complete = true;
        szn = 0;
        rank_lo = sent ? (Coord)occ_at<WIDE>(fused, 0, limb_bits) : 0;
      }
      const Coord posn = C[c_sel] + rank_lo;

      const bool upd_b = bwd_can && complete;
      const bool upd_f = fwd_can && complete;
      const bool b_exit = is_bwd && !bwd_can;
      const bool f_exit = !is_bwd && !fwd_can;
      int begin1 = upd_b ? begin - 1 : begin;
      int end1 = upd_f ? end + 1 : end;
      Coord sz1 = sz;
      if (do_ext && complete) {
        pos = posn;
        sz1 = szn;
      }
      // backward exit: a whole-prefix match ends the lane, else go forward
      const bool prefix_match = b_exit && begin == 0 && sz != 0;
      const bool to_fwd = b_exit && !prefix_match;
      // forward exit: emit the SFS (begin, end - begin + 1)
      if (f_exit) {
        if (t == 0 && count < cap) {
          oq[count] = begin1;
          ol[count] = end1 - begin1 + 1;
        }
        ++count;
      }
      const bool emit_done = f_exit && begin1 == 0;
      const bool restart = f_exit && !emit_done;
      // transitions re-seed from one symbol: going forward from P[begin]
      // (= c_acc), whose rank side is C[comp c]; going backward from
      // P[begin_new], whose rank side is C[c] (with overlap -1 that is
      // P[end - 1] = c_acc, the JAX kernel's re-seed)
      if (to_fwd) {
        dir = 1;
        end1 = begin1;
        pos = C[comp6(c_acc)];
        sz1 = C[c_acc + 1] - C[c_acc];
        // jump when the whole post-jump drift of the block stays in the
        // JAX package's chunk (safe_f, pingpong_jax.py:277)
        const int kpos = begin1 + jump_k - 1;
        const int key = jumps && kpos - base >= 0
                                && kpos - base + K_INNER + 1 < CHUNK
                            ? window_key(P, Lp1, kpos, jump_k, t) : -1;
        if (key >= 0) {
          ++jump_rows;
          const int4 r = __ldg(jt + key);
          if (r.z > 0) {
            pos = r.y;
            sz1 = r.z;
            end1 = kpos;
          }
        }
      } else if (restart) {
        dir = 0;
        const int begin_new = overlap == 0 ? begin1 - 1 : end1 + overlap;
        begin1 = begin_new;
        const int cr =
            (begin1 >= 0 && begin1 < Lp1) ? (int)__ldg(P + begin1) : 0;
        pos = C[cr];
        sz1 = C[cr + 1] - C[cr];
        // safe_b (pingpong_jax.py:276): room for k - 1 and a block's steps
        // below the jump, inside the chunk
        const int koff = begin_new - base;
        const int key = jumps && begin_new >= jump_k - 1
                                && koff >= jump_k + K_INNER && koff < CHUNK
                            ? window_key(P, Lp1, begin_new, jump_k, t) : -1;
        if (key >= 0) {
          ++jump_rows;
          const int4 r = __ldg(jt + key);
          if (r.z > 0) {
            pos = r.x;
            sz1 = r.z;
            begin1 = begin_new - (jump_k - 1);
          }
        }
      }
      if (prefix_match || emit_done) active = false;
      begin = begin1;
      end = end1;
      sz = sz1;
    }
    ++blocks;
    // overflowed lanes are redone on the host: stop walking them
    if (count > cap) {
      overflow = true;
      active = false;
    }
  }
  const int n = min(count, cap);
  for (int k = n + t; k < cap; k += WARP) {
    oq[k] = 0;
    ol[k] = 0;
  }
  if (t == 0) {
    n_sfs[lane] = n;
    ovf_o[lane] = overflow;
    inc_o[lane] = active;
    atomicMax(iters, blocks * K_INNER);
    if (work) atomicAdd(work, (unsigned long long)rank_steps);
    if (jump_work) atomicAdd(jump_work, (unsigned long long)jump_rows);
  }
}

template <typename Coord, bool WIDE>
void launch(const void* fused, const void* C, const void* seqs,
            const void* lens, const void* jt, int Q, int Lp1, int cap,
            int max_outer, int overlap, int limb_bits, int jump_k,
            int n_windows, void* out_qs, void* out_l, void* n_sfs,
            void* overflow, void* incomplete, void* iters, void* work,
            void* jump_work, cudaStream_t s) {
  pingpong_fm_kernel<Coord, WIDE>
      <<<(Q + WARPS - 1) / WARPS, THREADS, 0, s>>>(
          static_cast<const int32_t*>(fused), static_cast<const Coord*>(C),
          static_cast<const uint8_t*>(seqs),
          static_cast<const int32_t*>(lens), static_cast<const int4*>(jt),
          Q, Lp1, cap, max_outer, overlap, limb_bits, jump_k, n_windows,
          static_cast<int32_t*>(out_qs), static_cast<int32_t*>(out_l),
          static_cast<int32_t*>(n_sfs), static_cast<uint8_t*>(overflow),
          static_cast<uint8_t*>(incomplete), static_cast<int32_t*>(iters),
          static_cast<unsigned long long*>(work),
          static_cast<unsigned long long*>(jump_work));
}

}  // namespace

// limb_bits 0: narrow table, C int32[8]; else wide, C int64[8]. jump_k > 0
// (narrow only): jump mode with the int32[4^jump_k, 4] table jt and the
// JAX package's key-chunk count n_windows. work and jump_work (nullable)
// gain the rank steps and the jump-table rows read.
extern "C" int svdss_pingpong_fm(const void* fused, const void* C,
                                 const void* seqs, const void* lens,
                                 const void* jt, int Q, int Lp1, int cap,
                                 int max_outer, int overlap, int limb_bits,
                                 int jump_k, int n_windows, void* out_qs,
                                 void* out_l, void* n_sfs, void* overflow,
                                 void* incomplete, void* iters, void* work,
                                 void* jump_work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(iters, 0, sizeof(int32_t), s);
  if (Q > 0) {
    if (limb_bits)
      launch<long long, true>(fused, C, seqs, lens, nullptr, Q, Lp1, cap,
                              max_outer, overlap, limb_bits, 0, n_windows,
                              out_qs, out_l, n_sfs, overflow, incomplete,
                              iters, work, nullptr, s);
    else
      launch<int, false>(fused, C, seqs, lens, jt, Q, Lp1, cap, max_outer,
                         overlap, 0, jump_k, n_windows, out_qs, out_l, n_sfs,
                         overflow, incomplete, iters, work, jump_work, s);
  }
  return static_cast<int>(cudaGetLastError());
}
