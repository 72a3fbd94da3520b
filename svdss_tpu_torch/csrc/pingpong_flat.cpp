// The host engine's one-pass ping-pong search: every SFS of every read,
// whatever its count, in one call.
//
// The capped entry of native/pingpong.cpp (svdss_ping_pong_batch) stores
// at most `cap` SFSs a read and flags the rest, so a read past the cap is
// searched again at a larger one. Here each thread appends its reads'
// (qs, len) pairs to a buffer of its own, and after the join the pairs
// are laid out in read order in one malloc'd buffer: each read is
// searched once. The search loop is the same exact ping_pong.cpp:4-49
// walk (see ops/pingpong_host.py for the annotated Python oracle).
//
// The index handle is the svdss::RankIndex that native/pingpong.cpp's
// svdss_fmd_create makes; this file is compiled against the same rank.h
// (ops/pingpong_native.py builds it with g++, -I native).
//
// C ABI (ctypes):
//   int  svdss_ping_pong_batch_flat(void* fmd,
//            const uint8_t* reads, const int64_t* offsets, int64_t n_reads,
//            int overlap, int threads,
//            int64_t* out_n, int32_t** out_pairs, int64_t* out_total);
//   void svdss_flat_free(void* p);
//
// reads: concatenated nt6 read symbols, each followed by a 0 sentinel;
// read i occupies [offsets[i], offsets[i+1]). out_n[i] is read i's SFS
// count; *out_pairs (release with svdss_flat_free) holds out_total
// (qs, len) pairs in read order. Returns 1 if a read lacks its sentinel,
// 2 if the output cannot be allocated.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "rank.h"

namespace {

using i64 = int64_t;

struct Interval {
  i64 pos, sz;
};

inline Interval seed(const svdss::RankIndex &rk, int c) {
  return {rk.acc[c], rk.acc[c + 1] - rk.acc[c]};
}

inline Interval extend(const svdss::RankIndex &rk, Interval ik, int c) {
  i64 lo = rk.rank(c, ik.pos);
  i64 hi = rk.rank(c, ik.pos + ik.sz);
  return {rk.acc[c] + lo, hi - lo};
}

inline int comp6(int c) { return (c >= 1 && c <= 4) ? 5 - c : c; }

// Appends read P[0, l)'s SFSs to out as (qs, len); P[l] must be 0 (the NUL
// sentinel ends the forward phase, ping_pong.cpp:36).
void search_read(const svdss::RankIndex &rk, const uint8_t *P, i64 l,
                 int overlap, std::vector<int32_t> &out) {
  i64 begin = l - 1;
  while (begin >= 0) {
    // backward phase
    Interval ik = seed(rk, P[begin]);
    while (ik.sz != 0 && begin > 0) {
      --begin;
      ik = extend(rk, ik, P[begin]);
    }
    if (begin == 0 && ik.sz != 0) break;  // whole prefix matches
    // forward phase from the mismatch
    i64 end = begin;
    ik = seed(rk, comp6(P[end]));
    while (ik.sz != 0) {
      ++end;
      ik = extend(rk, ik, comp6(P[end]));  // P[l] == 0 stops (sz -> 0)
    }
    out.push_back((int32_t)begin);
    out.push_back((int32_t)(end - begin + 1));
    if (begin == 0) break;
    begin = overlap == 0 ? begin - 1 : end + overlap;
  }
}

}  // namespace

extern "C" {

int svdss_ping_pong_batch_flat(void *fmd, const uint8_t *reads,
                               const i64 *offsets, i64 n_reads, int overlap,
                               int threads, i64 *out_n, int32_t **out_pairs,
                               i64 *out_total) {
  const auto &rk = *static_cast<svdss::RankIndex *>(fmd);
  *out_pairs = nullptr;
  *out_total = 0;
  if (threads <= 0) threads = 1;
  // first[i] is read i's first pair in the buffer of thread owner[i]
  std::vector<std::vector<int32_t>> bufs(threads);
  std::vector<i64> first(n_reads);
  std::vector<int> owner(n_reads);
  std::atomic<i64> next{0};
  std::atomic<int> bad{0};
  auto worker = [&](int t) {
    auto &buf = bufs[t];
    for (;;) {
      i64 i = next.fetch_add(1);
      if (i >= n_reads) return;
      const uint8_t *P = reads + offsets[i];
      i64 l = offsets[i + 1] - offsets[i] - 1;  // trailing 0 sentinel
      if (l < 0 || P[l] != 0) { bad.store(1); return; }
      first[i] = (i64)buf.size() / 2;
      owner[i] = t;
      search_read(rk, P, l, overlap, buf);
      out_n[i] = (i64)buf.size() / 2 - first[i];
    }
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < threads; ++t) ts.emplace_back(worker, t);
  worker(0);
  for (auto &th : ts) th.join();
  if (bad.load()) return 1;
  i64 total = 0;
  for (i64 i = 0; i < n_reads; ++i) total += out_n[i];
  auto *out = (int32_t *)std::malloc(sizeof(int32_t) * 2 * (total ? total : 1));
  if (!out) return 2;
  i64 at = 0;
  for (i64 i = 0; i < n_reads; ++i) {
    if (out_n[i] == 0) continue;
    std::memcpy(out + 2 * at, bufs[owner[i]].data() + 2 * first[i],
                sizeof(int32_t) * 2 * out_n[i]);
    at += out_n[i];
  }
  *out_pairs = out;
  *out_total = total;
  return 0;
}

void svdss_flat_free(void *p) { std::free(p); }

}  // extern "C"
