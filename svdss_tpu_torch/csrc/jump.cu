// Kernel K6 (jump_level): one level of the k-mer jump table. From the n
// bi-intervals (x0, x1, sz, 0) of the level-j k-mers it writes the 4n
// intervals of their backward extensions by A, C, G, T: child (c - 1) * n +
// p of parent p, so that a key stays sum (sym - 1) * 4^i with the last
// symbol at 4^0. Launched once per level, k - 1 launches for a k-mer table.
//
// Replaces svdss_tpu/ops/fmd_jax.py:500 build_jump_table, with its level
// step :490 _extend_level and the bi-interval extension it runs, :297
// extend_select (:335 _gathered_rank, :348 _combine). Same rows, column for
// column. A parent with sz 0 is, in the JAX package, a masked lane that
// runs a 0-width query at position 0, where every checkpoint is 0 (row 0
// counts BWT[0:0]); its children are (C[c], x1, 0, 0), written here with
// no row read and no count.
//
// What bounds it on an H100. The first design was bound by instruction
// issue: the count of the five symbols $, A, C, G, T below each endpoint's
// offset took 2 endpoints x 32 words x 5 symbols x (xor, add, and-not,
// mask, popcount, accumulate), ~1,950 instructions a parent (1,674 in its
// SASS), 10.9 G over the 5.6M parents of a 12-mer table's levels 1-11; an
// SM issues 64 integer lanes a clock (16 for popcount), ~16.7 T/s at
// 1.98 GHz, 0.65 ms, the time it took. This design issues ~5x fewer, and
// its large levels now take as long as their loads and stores alone (a
// variant that skips the count: 0.159 against 0.167 ms for level 11's
// 4.2M parents), near the device-memory rate: a level reads its parents
// (16 B each) and the fused rows at lo = x0 and hi = x0 + sz (one row
// when lo >> 7 == hi >> 7, the rule at the deep levels) and writes four
// 16-byte children. The bytes floor of a 12-mer table over an 80M-symbol
// index is the 268 MB table written plus ~120 MB of rows read once,
// ~0.116 ms at 3.35 TB/s; the levels also pass ~90 MB of parents and
// ~90 MB of intermediate children, and a row is read once a parent.
//
// What the design does about it: it cuts the instructions a parent, with
// exact results.
// - An offset is below 128, so only nibble planes 0-3 of each packed word
//   (its low 16 bits) can be under a mask: words w and w + 16 are packed
//   into one (one byte permute), 16 words a row.
// - Each group of 4 packed words is bit-transposed (two delta-swap stages,
//   16 instructions) into three words holding bit 0, bit 1 and bit 2 of
//   every nibble code: bit 4n + j of plane b is bit b of nibble n of the
//   group's word j. The codes are $ 000, A 001, C 010, G 011, T 100, N
//   101, so five popcounts of the planes under the mask, b0, b1, b2,
//   b0 & b1 (G) and b0 & b2 (N), give all six counts: A = b0 - G - N,
//   C = b1 - G, T = b2 - N, $ = offset - b0 - b1 - b2 + G + N. The mask is
//   applied once a group and plane, not once a word and symbol, and each
//   popcount covers 32 positions of four words.
// - A group's mask is the full nibbles below offset >> 5 and, in nibble
//   offset >> 5, the words below offset & 31: four instructions a group.
// - When lo and hi share a row, the planes are made once and both
//   endpoints' masks are applied to them; the checkpoints cancel in sz and
//   x1, so only the occurrence checkpoints at lo are read.
// - An absent parent writes its children with no read and no count.
// The SASS for sm_90a (nvcc -O3, 52 registers) issues 456 instructions
// for a parent whose endpoints lie in two rows, 341 in one row (40
// popcounts in either) and 44 for an absent parent, against the ~1,950
// above; chip_smoke.py counts the run's parents of each kind and reports
// the instructions a parent and the time they take at the issue rates.
//
// One thread a parent; no shared memory (the rows a warp reads are
// scattered over the table).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DEV_BLOCK = 128;
constexpr int ROW_WORDS = 48;
constexpr int OCC_COLS = 16;
constexpr int THREADS = 256;
constexpr uint32_t M5 = 0x55555555u;
constexpr uint32_t M3 = 0x33333333u;

// bit planes 0, 1 and 2 of the nibble codes at span positions 0-127 of a
// fused row, four groups of four packed words
struct Planes {
  uint32_t b0[4], b1[4], b2[4];
};

__device__ __forceinline__ void load_planes(const int32_t* row, Planes& pl) {
  const int4* wv = reinterpret_cast<const int4*>(row + OCC_COLS);
  uint32_t w[32];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int4 x = __ldg(wv + v);
    w[4 * v] = (uint32_t)x.x;
    w[4 * v + 1] = (uint32_t)x.y;
    w[4 * v + 2] = (uint32_t)x.z;
    w[4 * v + 3] = (uint32_t)x.w;
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)   // nibbles 0-3 of words 4g+j and 4g+j+16
      y[j] = __byte_perm(w[4 * g + j], w[4 * g + j + 16], 0x5410);
    // the codes' bit 3 is 0, so a1 and a3 hold 0 in nibble bits 2-3
    const uint32_t a0 = (y[0] & M5) | ((y[1] & M5) << 1);
    const uint32_t a1 = ((y[0] >> 1) & M5) | (y[1] & ~M5);
    const uint32_t a2 = (y[2] & M5) | ((y[3] & M5) << 1);
    const uint32_t a3 = ((y[2] >> 1) & M5) | (y[3] & ~M5);
    pl.b0[g] = (a0 & M3) | ((a2 & M3) << 2);
    pl.b1[g] = a1 | (a3 << 2);
    pl.b2[g] = ((a0 >> 2) & M3) | (a2 & ~M3);
  }
}

// cnt[s] = count of symbol s ($, A, C, G, T) in BWT[128 * (pos >> 7) :
// pos], off = pos & 127, from the row's planes
__device__ __forceinline__ void counts(const Planes& pl, int off,
                                       int cnt[5]) {
  const int k = off >> 5;
  const uint32_t full = ((1u << (4 * k)) - 1u) * 0x10001u;
  const uint32_t words = (1u << (off & 31)) - 1u;
  int p0 = 0, p1 = 0, p2 = 0, pg = 0, pn = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t m =
        full | (((words >> (4 * g)) & 0x000F000Fu) << (4 * k));
    p0 += __popc(pl.b0[g] & m);
    p1 += __popc(pl.b1[g] & m);
    p2 += __popc(pl.b2[g] & m);
    pg += __popc(pl.b0[g] & pl.b1[g] & m);
    pn += __popc(pl.b0[g] & pl.b2[g] & m);
  }
  cnt[0] = off - p0 - p1 - p2 + pg + pn;
  cnt[1] = p0 - pg - pn;
  cnt[2] = p1 - pg;
  cnt[3] = pg;
  cnt[4] = p2 - pn;
}

// below[o - 1] = count of symbols whose complement-order position is below
// o, for o = 1..4: ord($) = 0, T = 1, G = 2, C = 3, A = 4
__device__ __forceinline__ void order_below(const int cnt[5], int below[4]) {
  below[0] = cnt[0];
  below[1] = below[0] + cnt[4];
  below[2] = below[1] + cnt[3];
  below[3] = below[2] + cnt[2];
}

__global__ void __launch_bounds__(THREADS)
jump_level_kernel(const int32_t* __restrict__ fused,
                  const int32_t* __restrict__ Cg,
                  const int4* __restrict__ parents, int n,
                  int4* __restrict__ children) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int4 par = parents[p];
  int4 ch[4];
  if (par.z <= 0) {
#pragma unroll
    for (int c = 1; c <= 4; ++c)
      ch[c - 1] = make_int4(__ldg(Cg + c), par.y, 0, 0);
  } else {
    const int lo = par.x, hi = par.x + par.z;
    const int32_t* rl = fused + (size_t)(lo >> 7) * ROW_WORDS;
    const int4 occ_a = __ldg(reinterpret_cast<const int4*>(rl));
    const int4 occ_b = __ldg(reinterpret_cast<const int4*>(rl) + 1);
    const int occ_lo[4] = {occ_a.y, occ_a.z, occ_a.w, occ_b.x};
    Planes pl;
    load_planes(rl, pl);
    int cl[5], chi[5];
    counts(pl, lo & (DEV_BLOCK - 1), cl);
    // checkpoint differences hi - lo: occurrence (c = 1..4) and order
    // prefix (o = 1..4); 0 when both endpoints share a row
    int d_occ[4] = {0, 0, 0, 0}, d_ord[4] = {0, 0, 0, 0};
    if ((hi >> 7) == (lo >> 7)) {
      counts(pl, hi & (DEV_BLOCK - 1), chi);
    } else {
      const int32_t* rh = fused + (size_t)(hi >> 7) * ROW_WORDS;
      const int4* rl4 = reinterpret_cast<const int4*>(rl);
      const int4* rh4 = reinterpret_cast<const int4*>(rh);
      const int4 hb0 = __ldg(rh4), hb1 = __ldg(rh4 + 1);
      const int4 la2 = __ldg(rl4 + 2), la3 = __ldg(rl4 + 3);
      const int4 hb2 = __ldg(rh4 + 2), hb3 = __ldg(rh4 + 3);
      Planes ph;
      load_planes(rh, ph);
      counts(ph, hi & (DEV_BLOCK - 1), chi);
      d_occ[0] = hb0.y - occ_lo[0];
      d_occ[1] = hb0.z - occ_lo[1];
      d_occ[2] = hb0.w - occ_lo[2];
      d_occ[3] = hb1.x - occ_lo[3];
      d_ord[0] = hb2.y - la2.y;
      d_ord[1] = hb2.z - la2.z;
      d_ord[2] = hb2.w - la2.w;
      d_ord[3] = hb3.x - la3.x;
    }
    int bl[4], bh[4];
    order_below(cl, bl);
    order_below(chi, bh);
#pragma unroll
    for (int c = 1; c <= 4; ++c) {
      const int o = 5 - c;   // complement-order position of c
      ch[c - 1] = make_int4(
          __ldg(Cg + c) + occ_lo[c - 1] + cl[c],
          par.y + d_ord[o - 1] + bh[o - 1] - bl[o - 1],
          d_occ[c - 1] + chi[c] - cl[c], 0);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) children[(size_t)c * n + p] = ch[c];
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
