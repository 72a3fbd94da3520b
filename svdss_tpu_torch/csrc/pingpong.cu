// Kernel K2 (pingpong_fm): ping-pong SFS search with the FM rank walk,
// narrow mode (index < 2^31 symbols), one thread per read lane.
//
// Replaces svdss_tpu/ops/pingpong_jax.py:117 batch_search (an XLA
// lockstep while-loop: step :185, outer body :314) and the rank step it
// runs, svdss_tpu/ops/fmd_jax.py:372 extend_rank_step. Same results, field
// for field: qs/length in emission order, n_sfs = min(count, cap),
// overflow checked every 48 steps, incomplete = still active at the step
// budget, iters = 48 x the most 48-step blocks any lane ran.
//
// What bounds it on an H100: each step of a lane is one dependent read of
// a 192-byte fused row at a data-dependent address (the FM walk), then
// ~32 popcounts. At chromosome scale the fused table (1.5 bytes/symbol,
// ~120 MB at 80M symbols) is larger than the 50 MB L2, so a step costs
// about one device-memory latency; a lane is a serial chain of such steps
// and the kernel is latency-bound, not bandwidth- or compute-bound. The
// bytes the work must move are one row per step.
//
// What the design does about it: lane state lives in registers and each
// lane runs to completion with no lockstep barrier, so a short lane never
// waits for the batch's slowest one (the XLA loop ran every lane until the
// last finished). Read symbols are loaded straight from the read
// (the TPU's 256-symbol chunk cache existed only because XLA lowered a
// per-lane dynamic index to a slow gather), and emissions go straight to
// the [Q, cap] outputs. One 32-thread block per warp of lanes spreads the
// lanes over as many SMs as possible; with ~2.3k lanes per batch that is
// still only ~72 warps, so latency hiding is poor — more lanes in flight
// per SM is the first thing to fix.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K_INNER = 48;   // steps between overflow checks
constexpr int DEV_BLOCK = 128;
constexpr int SPAN = 256;
constexpr int ROW_WORDS = 48;
constexpr int OCC_COLS = 16;
constexpr int THREADS = 32;

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

__global__ void __launch_bounds__(THREADS)
pingpong_fm_kernel(const int32_t* __restrict__ fused,
                   const int32_t* __restrict__ Cg,
                   const uint8_t* __restrict__ seqs,
                   const int32_t* __restrict__ lens,
                   int Q, int Lp1, int cap, int max_outer, int overlap,
                   int32_t* __restrict__ out_qs, int32_t* __restrict__ out_l,
                   int32_t* __restrict__ n_sfs, uint8_t* __restrict__ ovf_o,
                   uint8_t* __restrict__ inc_o, int32_t* __restrict__ iters,
                   unsigned long long* __restrict__ work) {
  __shared__ int C[8];
  if (threadIdx.x < 8) C[threadIdx.x] = Cg[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= Q) return;
  const uint8_t* P = seqs + (size_t)lane * Lp1;
  int32_t* oq = out_qs + (size_t)lane * cap;
  int32_t* ol = out_l + (size_t)lane * cap;

  const int len = lens[lane];
  bool active = len >= 1;
  int begin = len - 1, end = 0, dir = 0;   // dir 0 = backward, 1 = forward
  const int c0 = active ? P[begin] : 0;
  int pos = C[c0], sz = C[c0 + 1] - C[c0];
  bool pend = false;
  int p_rank = 0, count = 0, blocks = 0;
  long long rank_steps = 0;
  bool overflow = false;

  while (active && blocks < max_outer) {
    for (int k = 0; k < K_INNER && active; ++k) {
      const bool is_bwd = dir == 0;
      const bool bwd_can = is_bwd && sz != 0 && begin > 0;
      const bool fwd_can = !is_bwd && sz != 0;
      const bool do_ext = bwd_can || fwd_can;
      int a = is_bwd ? (bwd_can ? begin - 1 : begin)
                     : (fwd_can ? end + 1 : end - 1);
      a = max(a, 0);
      const int c_acc = a < Lp1 ? (int)P[a] : 0;
      const int c_sel = is_bwd ? c_acc : comp6(c_acc);
      // forward extension past the last base reads the NUL sentinel: its
      // interval is forced empty and the step completes at once
      const bool sent = !is_bwd && c_acc == 0;

      // rank step (fmd_jax.extend_rank_step); a lane that does not extend
      // runs it as a 0-width query at position 0
      const bool do_rank = do_ext && !sent;
      rank_steps += do_rank;
      const int lo = do_rank ? pos : 0;
      const int szm = do_rank ? sz : 0;
      const int off_lo = lo & (DEV_BLOCK - 1);
      const int off_hi = off_lo + szm;
      const int hi = lo + szm;
      const bool near = off_hi <= SPAN;
      const int m_hi = min(off_hi, SPAN);
      const int blk = pend ? (hi >> 7) : (lo >> 7);
      const int m_a = pend ? (hi & (DEV_BLOCK - 1)) : off_lo;
      const int32_t* row = fused + (size_t)blk * ROW_WORDS;
      const uint32_t cpat = (uint32_t)c_sel * 0x11111111u;
      int anchor = __ldg(row + c_sel);
      int cnt = 0;
      const int4* wv = reinterpret_cast<const int4*>(row + OCC_COLS);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int4 x4 = __ldg(wv + v);
        const uint32_t ws[4] = {(uint32_t)x4.x, (uint32_t)x4.y,
                                (uint32_t)x4.z, (uint32_t)x4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = 4 * v + j;
          // nibble-equality bits: sym, c <= 5 so x's nibbles are <= 7
          const uint32_t x = ws[j] ^ cpat;
          const uint32_t zm = ~(x + 0x77777777u) & 0x88888888u;
          anchor += __popc(zm & nib_mask_lt(m_a, w));
          cnt += __popc(zm & nib_mask_lt(m_hi, w) & ~nib_mask_lt(off_lo, w));
        }
      }
      bool complete = pend || near;
      const int rank_lo = pend ? p_rank : anchor;
      int szn = pend ? anchor - p_rank : cnt;
      const int posn = C[c_sel] + rank_lo;
      pend = do_rank && !near && !pend;
      p_rank = anchor;
      if (sent) szn = 0;
      complete = complete || sent;

      const bool upd_b = bwd_can && complete;
      const bool upd_f = fwd_can && complete;
      const bool b_exit = is_bwd && !bwd_can;
      const bool f_exit = !is_bwd && !fwd_can;
      int begin1 = upd_b ? begin - 1 : begin;
      int end1 = upd_f ? end + 1 : end;
      int sz1 = sz;
      if (do_ext && complete) {
        pos = posn;
        sz1 = szn;
      }
      // backward exit: a whole-prefix match ends the lane, else go forward
      const bool prefix_match = b_exit && begin == 0 && sz != 0;
      const bool to_fwd = b_exit && !prefix_match;
      // forward exit: emit the SFS (begin, end - begin + 1)
      if (f_exit) {
        if (count < cap) {
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
      } else if (restart) {
        dir = 0;
        begin1 = overlap == 0 ? begin1 - 1 : end1 + overlap;
        const int cr = (begin1 >= 0 && begin1 < Lp1) ? (int)P[begin1] : 0;
        pos = C[cr];
        sz1 = C[cr + 1] - C[cr];
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
  n_sfs[lane] = n;
  for (int k = n; k < cap; ++k) {
    oq[k] = 0;
    ol[k] = 0;
  }
  ovf_o[lane] = overflow;
  inc_o[lane] = active;
  atomicMax(iters, blocks * K_INNER);
  if (work) atomicAdd(work, (unsigned long long)rank_steps);
}

}  // namespace

extern "C" int svdss_pingpong_fm(const void* fused, const void* C,
                                 const void* seqs, const void* lens, int Q,
                                 int Lp1, int cap, int max_outer, int overlap,
                                 void* out_qs, void* out_l, void* n_sfs,
                                 void* overflow, void* incomplete,
                                 void* iters, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(iters, 0, sizeof(int32_t), s);
  if (Q > 0) {
    pingpong_fm_kernel<<<(Q + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        static_cast<const int32_t*>(fused), static_cast<const int32_t*>(C),
        static_cast<const uint8_t*>(seqs), static_cast<const int32_t*>(lens),
        Q, Lp1, cap, max_outer, overlap, static_cast<int32_t*>(out_qs),
        static_cast<int32_t*>(out_l), static_cast<int32_t*>(n_sfs),
        static_cast<uint8_t*>(overflow), static_cast<uint8_t*>(incomplete),
        static_cast<int32_t*>(iters),
        static_cast<unsigned long long*>(work));
  }
  return static_cast<int>(cudaGetLastError());
}
