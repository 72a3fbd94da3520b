// Kernel K1 (wavefront_dp): batched global alignment with two affine gap
// pieces (ksw2 extd2 scoring) over anti-diagonals, emitting per-cell
// traceback bits and each pair's final score.
//
// Replaces svdss_tpu/ops/align_pallas.py:36 _kernel (launched by
// wavefront_pallas, :158/:181) and its XLA twin
// svdss_tpu/ops/align_jax.py:35 _wavefront. Trace and scores match them
// bit for bit over the whole [D, W] array: every cell of every diagonal is
// computed, masked by `valid` only where the reference masks (H), so the
// E/F/E2/F2 values that drift down from NEG at invalid cells feed later
// cells exactly as there. Trace bits: H source in bits 0-2 (0 diag, 1 E,
// 2 F, 3 E2, 4 F2), bits 3-6 = E, F, E2, F2 came from their own extension
// (strict >, so an open wins a tie); ties in H break diag > E > F > E2 > F2.
//
// What bounds it on an H100: a pair is a serial chain of D = lq + lt + 1
// diagonals, each depending on the two before it, so a launch takes D
// times what one diagonal costs. The work itself is small (~40 integer
// operations and one trace byte a cell, so operations, not the B*D*W
// trace bytes, set the least time), but one block per pair keeps only B
// of the 132 SMs busy, and a diagonal's cells all run on that one SM.
// The parent design spent ~0.63 us a diagonal at 512 x 256 on two global
// loads (q[i-1], t[j-1]) and nine shared-memory accesses a cell around a
// block-wide barrier.
//
// What the design does about it (the register path): a thread owns C
// consecutive cells (C = 1, 2, 4 or 8, the least that covers W with the
// block's threads; fewer cells a thread measured faster at each width)
// and keeps their whole DP state in registers: H of the two diagonals
// before (H(d-1, i) and H(d-2, i-1)), E, E2, F, F2, the query symbol
// q[i-1] (loaded once) and the target symbol t[d-i-1]. Cell i reads at
// diagonal d what cell i-1 read at d-1, so the target symbols shift one
// cell a diagonal through the thread's registers and only the first
// cell's symbol is loaded, one diagonal ahead, off the chain. A cell's
// neighbour values H(d-1, i-1), F(d-1, i-1) and F2(d-1, i-1) come from
// its own registers or, for a thread's first cell, from lane - 1 by three
// warp shuffles; H(d-2, i-1) is what that cell received a diagonal
// before. Only lane 0 of each warp reads them from a double-buffered
// shared-memory exchange row, where lane 31 of the warp before wrote them
// at the previous diagonal; one __syncthreads() a diagonal orders that
// exchange (a clock64() split put it at ~15 cycles: the warps arrive
// together). Cells update from the thread's last to its first, so each
// reads its neighbour's values before they change. With one cell a
// thread the warp stores its 32 trace bytes as one; with C > 1 each warp
// stages its 32 * C bytes in shared memory and stores them back so that
// consecutive threads write consecutive bytes. The score is taken once,
// at the target diagonal, from the thread that owns the target cell.
//
// Widths past the register path (W > 5,120: 640 threads of 8 cells, the
// most whose state fits 102 registers a thread) take the parent design
// with its state in a global scratch the wrapper allocates as
// svdss_wavefront_scratch_words says: one block per pair, threads
// striding over the W cells, nine state rows of W int32 each.
//
// What is left: the cells of a diagonal run on one SM (17 warps at the
// call stage's buckets), ~0.35 us a diagonal at 512 x 256 on an H100,
// most of it the cells' own instructions. Splitting a pair's diagonal
// over a cluster of blocks, with the neighbour values passed through
// distributed shared memory, would spread that work over more SMs at the
// price of a cluster-wide handoff each diagonal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -100000000;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STATE_ROWS = 9;       // global-scratch path: int32 rows of W
constexpr int SCRATCH_THREADS = 1024;

// Register path: cells a thread, and the most threads a block for each
// (so that C cells' state, 8 registers a cell, fits the registers a
// thread then has: 64 at 1,024 threads, 85 at 768, 102 at 640).
constexpr int CELLS[4] = {1, 2, 4, 8};
constexpr int MAX_THREADS[4] = {1024, 1024, 768, 640};

struct Scores {
  int m, mis, oe1, e1, oe2, e2;
};

// The register path's cells a thread at width W (0: past it).
int cells_for(int W) {
  for (int s = 0; s < 4; ++s)
    if (W <= CELLS[s] * MAX_THREADS[s]) return CELLS[s];
  return 0;
}

// Target symbol x with the reference's out-of-range code.
__device__ __forceinline__ int tsym(const int32_t* tb, int lt, int x) {
  return (unsigned)x < (unsigned)lt ? __ldg(tb + x) : -1;
}

// C trace bytes packed little-endian into one shared-memory store.
template <int C>
__device__ __forceinline__ void put_bytes(uint8_t* dst, const uint32_t* v) {
  if constexpr (C == 1) {
    dst[0] = (uint8_t)v[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(v[0] | v[1] << 8);
  } else {
#pragma unroll
    for (int w = 0; w < C / 4; ++w)
      reinterpret_cast<uint32_t*>(dst)[w] =
          v[4 * w] | v[4 * w + 1] << 8 | v[4 * w + 2] << 16 |
          v[4 * w + 3] << 24;
  }
}

template <int C, int MAXT>
__global__ void __launch_bounds__(MAXT)
wavefront_reg_kernel(const int32_t* __restrict__ q,
                     const int32_t* __restrict__ t,
                     const int32_t* __restrict__ tgt_d,
                     const int32_t* __restrict__ tgt_i, int lq, int lt,
                     Scores p, uint8_t* __restrict__ trace,
                     int32_t* __restrict__ score) {
  // lane 31's (H, F, F2) of its last cell, by warp, at diagonals of
  // either parity; each warp's trace bytes of a diagonal, staged so that
  // consecutive threads store consecutive bytes
  __shared__ int4 xch[2][MAXT / WARP];
  __shared__ __align__(16) uint8_t stage[C > 1 ? MAXT * C : 1];
  const int b = blockIdx.x;
  const int W = lq + 1;
  const int D = lq + lt + 1;
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int c0 = threadIdx.x * C;
  const int32_t* qb = q + (size_t)b * lq;
  const int32_t* tb = t + (size_t)b * lt;
  uint8_t* tr = trace + (size_t)b * D * W;
  const int td = tgt_d[b];
  const int tj = tgt_i[b] - c0;          // the target cell's j, if mine

  // d = 0: only H(0,0) = 0; the trace row is all zero. tv[j] is
  // t[d - i - 1] of cell i = c0 + j, shifted in as the diagonals advance
  int h1[C], hd[C], e[C], e2[C], f[C], f2[C], qv[C], tv[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int i = c0 + j;
    h1[j] = i == 0 ? 0 : NEG;            // H(d-1, i)
    hd[j] = NEG;                         // H(d-2, i-1)
    e[j] = e2[j] = f[j] = f2[j] = NEG;
    qv[j] = (i >= 1 && i <= lq) ? __ldg(qb + i - 1) : -2;
    tv[j] = -1;
    if (i < W) tr[i] = 0;
  }
  int tnext = tsym(tb, lt, -c0);         // cell c0's symbol at d = 1
  if (lane == WARP - 1) xch[0][warp] = make_int4(h1[C - 1], f[C - 1],
                                                 f2[C - 1], 0);
  if (threadIdx.x == 0) score[b] = NEG;
  __syncthreads();

  uint8_t* trow = tr;
  for (int d = 1; d < D; ++d) {
    trow += W;
#pragma unroll
    for (int j = C - 1; j > 0; --j) tv[j] = tv[j - 1];
    tv[0] = tnext;
    tnext = tsym(tb, lt, d - c0);
    // the left neighbour's H, F, F2 at d - 1
    int lh = __shfl_up_sync(FULL, h1[C - 1], 1);
    int lf = __shfl_up_sync(FULL, f[C - 1], 1);
    int lf2 = __shfl_up_sync(FULL, f2[C - 1], 1);
    if (lane == 0) {
      if (warp == 0) {
        lh = lf = lf2 = NEG;
      } else {
        const int4 x = xch[(d - 1) & 1][warp - 1];
        lh = x.x;
        lf = x.y;
        lf2 = x.z;
      }
    }
    // cell i is in the band [ilo, ihi] iff (unsigned)(i - ilo) <= span
    const int ilo = max(0, d - lt);
    const unsigned span = min(lq, d) - ilo;
    const int base = c0 - ilo;
    uint32_t bits[C];
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
      const int hl = j ? h1[j - 1] : lh;   // H(d-1, i-1)
      const int fl = j ? f[j - 1] : lf;    // F(d-1, i-1)
      const int f2l = j ? f2[j - 1] : lf2;
      // E(i, j) from (i, j-1): diagonal d-1, same i
      const int e_open = h1[j] - p.oe1, e_ext = e[j] - p.e1;
      const int Ev = max(e_open, e_ext);
      const int e2_open = h1[j] - p.oe2, e2_ext = e2[j] - p.e2;
      const int E2v = max(e2_open, e2_ext);
      // F(i, j) from (i-1, j): diagonal d-1, index i-1
      const int f_open = hl - p.oe1, f_ext = fl - p.e1;
      const int Fv = max(f_open, f_ext);
      const int f2_open = hl - p.oe2, f2_ext = f2l - p.e2;
      const int F2v = max(f2_open, f2_ext);
      // diagonal from (i-1, j-1): diagonal d-2, index i-1
      int best = hd[j] + (qv[j] == tv[j] ? p.m : p.mis);
      int src = 0;
      if (Ev > best) { best = Ev; src = 1; }
      if (Fv > best) { best = Fv; src = 2; }
      if (E2v > best) { best = E2v; src = 3; }
      if (F2v > best) { best = F2v; src = 4; }
      if ((unsigned)(base + j) > span) best = NEG;
      bits[j] = src | ((e_ext > e_open) << 3) | ((f_ext > f_open) << 4) |
                ((e2_ext > e2_open) << 5) | ((f2_ext > f2_open) << 6);
      hd[j] = hl;
      h1[j] = best;
      e[j] = Ev;
      e2[j] = E2v;
      f[j] = Fv;
      f2[j] = F2v;
    }
    if (d == td && tj >= 0 && tj < C) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j == tj) score[b] = h1[j];
    }
    if (lane == WARP - 1)
      xch[d & 1][warp] = make_int4(h1[C - 1], f[C - 1], f2[C - 1], 0);
    // the trace row: with one cell a thread the warp's stores are already
    // consecutive; else through the warp's stage, byte j * 32 + lane of
    // its 32 * C cells by this thread
    if constexpr (C == 1) {
      if (c0 < W) trow[c0] = (uint8_t)bits[0];
    } else {
      uint8_t* ws = stage + warp * WARP * C;
      put_bytes<C>(ws + lane * C, bits);
      __syncwarp();
      const int wc0 = warp * WARP * C;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int x = j * WARP + lane;
        if (wc0 + x < W) trow[wc0 + x] = ws[x];
      }
    }
    __syncthreads();
  }
}

// The global-scratch path: state rows in scratch [B, STATE_ROWS, W].
__global__ void __launch_bounds__(SCRATCH_THREADS)
wavefront_scratch_kernel(const int32_t* __restrict__ q,
                         const int32_t* __restrict__ t,
                         const int32_t* __restrict__ tgt_d,
                         const int32_t* __restrict__ tgt_i, int lq, int lt,
                         Scores p, uint8_t* __restrict__ trace,
                         int32_t* __restrict__ score,
                         int32_t* __restrict__ scratch) {
  const int b = blockIdx.x;
  const int W = lq + 1;
  const int D = lq + lt + 1;
  int32_t* st = scratch + (size_t)b * STATE_ROWS * W;
  int32_t* Hrow[3] = {st, st + W, st + 2 * W};
  int32_t* E = st + 3 * W;
  int32_t* E2 = st + 4 * W;
  int32_t* Frow[2] = {st + 5 * W, st + 6 * W};
  int32_t* F2row[2] = {st + 7 * W, st + 8 * W};
  const int32_t* qb = q + (size_t)b * lq;
  const int32_t* tb = t + (size_t)b * lt;
  uint8_t* tr = trace + (size_t)b * D * W;
  const int td = tgt_d[b];
  const int ti = tgt_i[b];

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    Hrow[0][i] = NEG;
    Hrow[1][i] = i == 0 ? 0 : NEG;
    E[i] = NEG;
    E2[i] = NEG;
    Frow[0][i] = NEG;
    F2row[0][i] = NEG;
    tr[i] = 0;
  }
  if (threadIdx.x == 0) score[b] = NEG;
  __syncthreads();

  int h2 = 0, h1 = 1, hn = 2, fp = 0;
  for (int d = 1; d < D; ++d) {
    const int32_t* H2 = Hrow[h2];
    const int32_t* H1 = Hrow[h1];
    int32_t* Hn = Hrow[hn];
    const int32_t* Fp = Frow[fp];
    int32_t* Fn = Frow[fp ^ 1];
    const int32_t* F2p = F2row[fp];
    int32_t* F2n = F2row[fp ^ 1];
    const int ilo = max(0, d - lt);
    const int ihi = min(lq, d);
    uint8_t* trow = tr + (size_t)d * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const int hup = H1[i];
      const int e_open = hup - p.oe1, e_ext = E[i] - p.e1;
      const int Ev = max(e_open, e_ext);
      const int e2_open = hup - p.oe2, e2_ext = E2[i] - p.e2;
      const int E2v = max(e2_open, e2_ext);
      const int hleft = i > 0 ? H1[i - 1] : NEG;
      const int f_open = hleft - p.oe1;
      const int f_ext = (i > 0 ? Fp[i - 1] : NEG) - p.e1;
      const int Fv = max(f_open, f_ext);
      const int f2_open = hleft - p.oe2;
      const int f2_ext = (i > 0 ? F2p[i - 1] : NEG) - p.e2;
      const int F2v = max(f2_open, f2_ext);
      const int qv = i == 0 ? -2 : qb[i - 1];
      int best = (i > 0 ? H2[i - 1] : NEG) +
                 (qv == tsym(tb, lt, d - i - 1) ? p.m : p.mis);
      int src = 0;
      if (Ev > best) { best = Ev; src = 1; }
      if (Fv > best) { best = Fv; src = 2; }
      if (E2v > best) { best = E2v; src = 3; }
      if (F2v > best) { best = F2v; src = 4; }
      if (i < ilo || i > ihi) best = NEG;
      trow[i] = static_cast<uint8_t>(
          src | ((e_ext > e_open) << 3) | ((f_ext > f_open) << 4) |
          ((e2_ext > e2_open) << 5) | ((f2_ext > f2_open) << 6));
      Hn[i] = best;
      E[i] = Ev;
      E2[i] = E2v;
      Fn[i] = Fv;
      F2n[i] = F2v;
      if (d == td && i == ti) score[b] = best;
    }
    __syncthreads();
    const int tmp = h2;
    h2 = h1;
    h1 = hn;
    hn = tmp;
    fp ^= 1;
  }
}

template <int C, int MAXT>
cudaError_t launch_reg(int B, int W, const int32_t* q, const int32_t* t,
                       const int32_t* tgt_d, const int32_t* tgt_i, int lq,
                       int lt, Scores p, uint8_t* trace, int32_t* score,
                       cudaStream_t s) {
  const int threads = ((W + C - 1) / C + WARP - 1) / WARP * WARP;
  wavefront_reg_kernel<C, MAXT><<<B, threads, 0, s>>>(
      q, t, tgt_d, tgt_i, lq, lt, p, trace, score);
  return cudaGetLastError();
}

}  // namespace

// The one place that decides which path a width takes: the int32 words of
// global scratch each pair needs at query length lq, 0 when the register
// path takes its width W = lq + 1 (W <= 5,120). It depends on no property
// of the card.
extern "C" int svdss_wavefront_scratch_words(int lq) {
  const int W = lq + 1;
  return cells_for(W) ? 0 : STATE_ROWS * W;
}

// scratch: [B, STATE_ROWS, W] int32 in device memory where
// svdss_wavefront_scratch_words asks for it, else unused (may be null).
extern "C" int svdss_wavefront_dp(const void* q, const void* t,
                                  const void* tgt_d, const void* tgt_i, int B,
                                  int lq, int lt, int m, int mis, int o1,
                                  int e1, int o2, int e2, void* trace,
                                  void* score, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = lq + 1;
  const Scores p{m, mis, o1 + e1, e1, o2 + e2, e2};
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* tp = static_cast<const int32_t*>(t);
  const auto* dp = static_cast<const int32_t*>(tgt_d);
  const auto* ip = static_cast<const int32_t*>(tgt_i);
  auto* trp = static_cast<uint8_t*>(trace);
  auto* sp = static_cast<int32_t*>(score);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  switch (cells_for(W)) {
    case 1:
      return launch_reg<1, MAX_THREADS[0]>(B, W, qp, tp, dp, ip, lq, lt, p,
                                           trp, sp, s);
    case 2:
      return launch_reg<2, MAX_THREADS[1]>(B, W, qp, tp, dp, ip, lq, lt, p,
                                           trp, sp, s);
    case 4:
      return launch_reg<4, MAX_THREADS[2]>(B, W, qp, tp, dp, ip, lq, lt, p,
                                           trp, sp, s);
    case 8:
      return launch_reg<8, MAX_THREADS[3]>(B, W, qp, tp, dp, ip, lq, lt, p,
                                           trp, sp, s);
    default:
      if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      wavefront_scratch_kernel<<<B, SCRATCH_THREADS, 0, s>>>(
          qp, tp, dp, ip, lq, lt, p, trp, sp,
          static_cast<int32_t*>(scratch));
      return static_cast<int>(cudaGetLastError());
  }
}
