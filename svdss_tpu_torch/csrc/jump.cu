// Kernel K6 (jump_level): one level of the k-mer jump table. From the n
// bi-intervals (x0, x1, sz, 0) of the level-j k-mers it writes the 4n
// intervals of their backward extensions by A, C, G, T: child (c - 1) * n +
// p of parent p, so that a key stays sum (sym - 1) * 4^i with the last
// symbol at 4^0. Launched once per level, k - 1 launches for a k-mer table.
//
// Replaces svdss_tpu/ops/fmd_jax.py:500 build_jump_table, with its level
// step :490 _extend_level and the bi-interval extension it runs, :297
// extend_select (:335 _gathered_rank, :348 _combine). Same rows, column for
// column: a parent with sz 0 runs, as the JAX package's masked lanes do, a
// 0-width query at position 0, so its children are (C[c], x1, 0, 0).
//
// What bounds it on an H100: bytes. A parent reads the 192-byte fused rows
// at lo = x0 and hi = x0 + sz (often the same row) at data-dependent
// addresses, and its four children write 64 bytes. At k = 12 over an 80M
// symbol index the last level has 4.2M parents, which between them touch
// nearly every row of the 120 MB table; the table written is 268 MB.
//
// What the design does about it: one thread per parent reads both endpoint
// rows once and produces all four children, since the four extensions share
// both endpoints (the JAX package gathers both rows once per child, eight
// row reads a parent). The counts of the symbols $, A, C, G, T below each
// endpoint's offset come from the packed nibble words with one bit-parallel
// equality and a popcount per word and symbol; rank and complement-order
// counts are those partial counts plus the rows' checkpoints. No shared
// memory: the rows a warp reads are scattered over the table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DEV_BLOCK = 128;
constexpr int ROW_WORDS = 48;
constexpr int OCC_COLS = 16;
constexpr int ORD_COLS = 8;
constexpr int THREADS = 256;

// bit (8 << 4j) of word w set iff span position 32*j + w < bound (bound in
// [0, 128): only the first four nibble planes can be set)
__device__ __forceinline__ uint32_t nib_mask_lt(int bound, int w) {
  const int k = bound >> 5;
  const uint32_t full = ((1u << (4 * k)) - 1u) & 0x88888888u;
  return full | (w < (bound & 31) ? (8u << (4 * k)) : 0u);
}

// cnt[s] = count of symbol s (0..4) in BWT[128 * (pos >> 7) : pos], from the
// row's packed words; row = that block's fused row
__device__ __forceinline__ void partial_counts(const int32_t* row, int off,
                                               int cnt[5]) {
#pragma unroll
  for (int s = 0; s < 5; ++s) cnt[s] = 0;
  const int4* wv = reinterpret_cast<const int4*>(row + OCC_COLS);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int4 x4 = __ldg(wv + v);
    const uint32_t ws[4] = {(uint32_t)x4.x, (uint32_t)x4.y, (uint32_t)x4.z,
                            (uint32_t)x4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t m = nib_mask_lt(off, 4 * v + j);
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        // nibble-equality bits: symbols are <= 5, so x's nibbles are <= 7
        const uint32_t x = ws[j] ^ ((uint32_t)s * 0x11111111u);
        cnt[s] += __popc(~(x + 0x77777777u) & 0x88888888u & m);
      }
    }
  }
}

// rank[c] = count of c in BWT[0:pos) for c = 1..4 (index c - 1), and
// ordp[o] = count of symbols whose complement-order position is below o,
// for o = 1..4 (index o - 1): ord($) = 0, T = 1, G = 2, C = 3, A = 4
__device__ __forceinline__ void counts_at(const int32_t* __restrict__ fused,
                                          int pos, int rank[4], int ordp[4]) {
  const int32_t* row = fused + (size_t)(pos >> 7) * ROW_WORDS;
  int cnt[5];
  partial_counts(row, pos & (DEV_BLOCK - 1), cnt);
#pragma unroll
  for (int c = 1; c <= 4; ++c) rank[c - 1] = __ldg(row + c) + cnt[c];
  const int below[4] = {cnt[0], cnt[0] + cnt[4], cnt[0] + cnt[4] + cnt[3],
                        cnt[0] + cnt[4] + cnt[3] + cnt[2]};
#pragma unroll
  for (int o = 1; o <= 4; ++o)
    ordp[o - 1] = __ldg(row + ORD_COLS + o) + below[o - 1];
}

__global__ void __launch_bounds__(THREADS)
jump_level_kernel(const int32_t* __restrict__ fused,
                  const int32_t* __restrict__ Cg,
                  const int4* __restrict__ parents, int n,
                  int4* __restrict__ children) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int4 par = parents[p];
  const bool live = par.z > 0;
  const int lo = live ? par.x : 0;
  const int hi = live ? par.x + par.z : 0;
  int rank_lo[4], ord_lo[4], rank_hi[4], ord_hi[4];
  counts_at(fused, lo, rank_lo, ord_lo);
  counts_at(fused, hi, rank_hi, ord_hi);
#pragma unroll
  for (int c = 1; c <= 4; ++c) {
    const int o = 5 - c;   // complement-order position of c
    int4 ch;
    ch.x = __ldg(Cg + c) + rank_lo[c - 1];
    ch.y = par.y + (ord_hi[o - 1] - ord_lo[o - 1]);
    ch.z = live ? rank_hi[c - 1] - rank_lo[c - 1] : 0;
    ch.w = 0;
    children[(size_t)(c - 1) * n + p] = ch;
  }
}

}  // namespace

// fused int32[nblk, 48] narrow table, C int32[8], parents int32[n, 4],
// children int32[4n, 4]
extern "C" int svdss_jump_level(const void* fused, const void* C,
                                const void* parents, int n, void* children,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    jump_level_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        static_cast<const int32_t*>(fused), static_cast<const int32_t*>(C),
        static_cast<const int4*>(parents), n, static_cast<int4*>(children));
  return static_cast<int>(cudaGetLastError());
}
