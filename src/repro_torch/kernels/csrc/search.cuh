// Shared device code of the search kernels (search_bounds_words.cu,
// search_bounds_bytes.cu, search_fetch_words.cu, search_fetch_bytes.cu):
// the fixed-trip binary search of one row over the suffix array, and the
// one-time read of its pattern row.
#pragma once
#include <cstdint>

#include "probe_words.cuh"

namespace search {

constexpr int kThreads = 64;     // a block: 512 rows spread over 8 SMs
constexpr int kMaxBlocks = 8192; // grid-stride beyond (~2x what is resident)

__device__ __forceinline__ long long clamp_row(long long x, long long total) {
  return x < 0 ? 0 : (x > total - 1 ? total - 1 : x);
}

// Lower bound (upper == false: the first suffix >= the pattern, a prefix
// match counting as >=) or upper bound (the first suffix > the pattern) of
// one row in [lo, hi), with at most n_iter trips, exactly as the loop
// repro_torch.kernels.search.search_loop runs them: mid = (lo + hi) / 2,
// the verdict at ell[clamp(mid, 0, total - 1)], then lo = mid + 1 or
// hi = mid.  The caller passes lo < hi and n_iter > 0; the row stops once
// lo >= hi, where the loop leaves it unchanged.
//
// Both candidate next midpoints are known before the verdict resolves:
// (mid + 1 + hi) / 2 if lo moves, (lo + mid) / 2 if hi does.  Their ell
// entries are loaded before the verdict's text reads, so the trip's two
// dependent reads (ell, then the text there) overlap with the next
// trip's ell read and a trip costs about one DRAM round trip.
template <class Verdict>
__device__ __forceinline__ long long search_row(
    const int32_t* __restrict__ ell, long long total, long long lo,
    long long hi, int n_iter, bool upper, const Verdict& verdict) {
  long long mid = (lo + hi) >> 1;  // lo, hi >= 0: the loop's floor division
  int32_t pos = __ldg(ell + clamp_row(mid, total));
  for (int t = 0; t < n_iter; ++t) {
    const long long mid_r = (mid + 1 + hi) >> 1;
    const long long mid_l = (lo + mid) >> 1;
    const int32_t pos_r = __ldg(ell + clamp_row(mid_r, total));
    const int32_t pos_l = __ldg(ell + clamp_row(mid_l, total));
    const int c = verdict(pos);
    if (upper ? c <= 0 : c < 0) {
      lo = mid + 1;
      mid = mid_r;
      pos = pos_r;
    } else {
      hi = mid;
      mid = mid_l;
      pos = pos_l;
    }
    if (lo >= hi) break;
  }
  return lo;
}

// Pattern row i (nw words) into registers, zero past nw.
template <int N>
__device__ __forceinline__ RegRow<N> load_row(
    const uint32_t* __restrict__ pat, const uint32_t* __restrict__ mask,
    long long i, int nw) {
  RegRow<N> row;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    row.pat[j] = j < nw ? __ldg(pat + i * nw + j) : 0u;
    row.mask[j] = j < nw ? __ldg(mask + i * nw + j) : 0u;
  }
  return row;
}

// Pattern row i into this thread's slots of the block's dynamic shared
// memory (2 * nw * blockDim.x words: the pattern words, then the mask
// words, word j of thread t at [j * blockDim.x + t]).  Each thread reads
// only its own slots, so no barrier is needed.
__device__ __forceinline__ SharedRow stage_row(
    uint32_t* stage, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, long long i, int nw) {
  const int stride = blockDim.x;
  uint32_t* sp = stage + threadIdx.x;
  uint32_t* sm = stage + (long long)nw * stride + threadIdx.x;
  for (int j = 0; j < nw; ++j) {
    sp[j * stride] = __ldg(pat + i * nw + j);
    sm[j * stride] = __ldg(mask + i * nw + j);
  }
  return SharedRow{sp, sm, stride};
}

// Launch shape of rows = B * bounds threads; the shared-memory route's
// bytes, opted in above the 48 KB default.
inline unsigned blocks_for(long long rows) {
  long long blocks = (rows + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

inline size_t stage_bytes(int nw) {
  return (size_t)2 * nw * kThreads * sizeof(uint32_t);
}

}  // namespace search
