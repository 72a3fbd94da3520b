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
// What bounds it on an H100: integer work. Each cell costs ~37 32-bit
// integer operations (counted from the recurrence below) and writes one
// trace byte, reading nothing from device memory but two sequence
// symbols; at 37 operations per byte moved the operations, not the
// B*D*W trace bytes (268 MB for 8 pairs at the 4096 x 4096 bucket), set
// the least time. The recurrence along a diagonal is a serial chain of
// D dependent steps per pair, so a pair is also latency-bound.
//
// What the design does about it: one thread block per pair walks the
// diagonals d = 1..D-1 with one __syncthreads() each, its threads
// striding over the W cells; the DP state (three H rows for d, d-1 and
// d-2, E and E2 updated in place since a cell reads only its own index,
// F and F2 double-buffered because cell i reads cell i-1 of the previous
// diagonal) stays in shared memory (36 bytes per cell of width, so up to
// W = 6456 on an H100's 227 KB opt-in) or, past that, in a global scratch
// the wrapper allocates as svdss_wavefront_scratch_words says. Each
// diagonal's trace row is written by consecutive threads to consecutive
// bytes. The substitution score is computed in the kernel from q and t;
// the TPU kernel's precomputed [D, B, W] substitution tensor is not needed.
// One block per pair leaves most SMs idle on small batches: splitting a
// pair's diagonal over a cluster of blocks is the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -100000000;
constexpr int STATE_ROWS = 9;

__global__ void __launch_bounds__(1024)
wavefront_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
                 const int32_t* __restrict__ tgt_d,
                 const int32_t* __restrict__ tgt_i, int lq, int lt, int m,
                 int mis, int oe1, int e1, int oe2, int e2,
                 uint8_t* __restrict__ trace, int32_t* __restrict__ score,
                 int32_t* __restrict__ scratch) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int W = lq + 1;
  const int D = lq + lt + 1;
  int32_t* st = scratch ? scratch + (size_t)b * STATE_ROWS * W : smem;
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

  // d = 0: only H(0,0) = 0; the trace row is all zero
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
      // E(i, j) from (i, j-1): diagonal d-1, same i
      const int hup = H1[i];
      const int e_open = hup - oe1, e_ext = E[i] - e1;
      const int Ev = max(e_open, e_ext);
      const int e2_open = hup - oe2, e2_ext = E2[i] - e2;
      const int E2v = max(e2_open, e2_ext);
      // F(i, j) from (i-1, j): diagonal d-1, index i-1
      const int hleft = i > 0 ? H1[i - 1] : NEG;
      const int f_open = hleft - oe1;
      const int f_ext = (i > 0 ? Fp[i - 1] : NEG) - e1;
      const int Fv = max(f_open, f_ext);
      const int f2_open = hleft - oe2;
      const int f2_ext = (i > 0 ? F2p[i - 1] : NEG) - e2;
      const int F2v = max(f2_open, f2_ext);
      // diagonal from (i-1, j-1): diagonal d-2, index i-1; q[i-1] vs
      // t[d-i-1] with the reference's out-of-range codes
      const int j1 = d - i - 1;
      const int tv = (j1 >= 0 && j1 < lt) ? tb[j1] : -1;
      const int qv = i == 0 ? -2 : qb[i - 1];
      int best = (i > 0 ? H2[i - 1] : NEG) + (qv == tv ? m : mis);
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

}  // namespace

// The one place that decides where the DP state lives: the int32 words of
// global scratch each pair needs at query length lq on the current device,
// 0 when its STATE_ROWS * 4 * W bytes fit the shared memory a block may
// opt in to there. A failed device query returns minus its cudaError_t.
extern "C" int svdss_wavefront_scratch_words(int lq) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t words = (size_t)STATE_ROWS * (lq + 1);
  return words * sizeof(int32_t) <= (size_t)limit ? 0
                                                   : static_cast<int>(words);
}

// scratch == nullptr: DP state in dynamic shared memory, as
// svdss_wavefront_scratch_words allows; else scratch is [B, STATE_ROWS, W]
// int32 in device memory.
extern "C" int svdss_wavefront_dp(const void* q, const void* t,
                                  const void* tgt_d, const void* tgt_i, int B,
                                  int lq, int lt, int m, int mis, int o1,
                                  int e1, int o2, int e2, void* trace,
                                  void* score, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = lq + 1;
  const int threads = min(1024, (W + 31) / 32 * 32);
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)STATE_ROWS * sizeof(int32_t) * W;
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0) {
    wavefront_kernel<<<B, threads, smem, s>>>(
        static_cast<const int32_t*>(q), static_cast<const int32_t*>(t),
        static_cast<const int32_t*>(tgt_d), static_cast<const int32_t*>(tgt_i),
        lq, lt, m, mis, o1 + e1, e1, o2 + e2, e2,
        static_cast<uint8_t*>(trace), static_cast<int32_t*>(score),
        static_cast<int32_t*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
