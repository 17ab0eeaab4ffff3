// Shared device helper of the byte-key probes on the terminal-padded uint8
// string: the -1/0/+1 verdict of the masked byte keys of the suffix at p0
// against a packed pattern row, compared unsigned at the first differing
// word (0: the suffix starts with the pattern).  pattern_probe.cu (one
// search step), search_bounds_bytes.cu (the whole search) and
// search_fetch_bytes.cu (search and find-and-fetch in one launch, through
// the ByteText policy of search.cuh's kernels) decide with this code.  Row
// types (GlobalRow, RegRow, SharedRow) are those of probe_words.cuh.
#pragma once
#include <cstdint>

#include "byte_read.cuh"
#include "probe_words.cuh"

// NWR > 0 unrolls the walk over NWR words (nw <= NWR), as a register row
// needs; NWR == 0 walks nw words.  A zero mask word skips its load;
// uint32_t compares are unsigned, which byte codes >= 128 need (C5).
template <int NWR, class Row>
__device__ __forceinline__ int probe_bytes_verdict(
    const uint8_t* __restrict__ s, long long n_s, long long p0,
    const Row& row, int nw) {
  int v = 0;
#pragma unroll
  for (int j = 0; j < (NWR > 0 ? NWR : nw); ++j) {
    if (NWR > 0 && j >= nw) break;
    uint32_t m = row.m(j);
    uint32_t sw = m ? (byte_key_word(s, n_s, p0 + 4LL * j) & m) : 0u;
    uint32_t pw = row.p(j);
    if (sw != pw) {
      v = sw < pw ? -1 : 1;
      break;
    }
  }
  return v;
}

// The Text policy of search.cuh's byte-key kernels on the terminal-padded
// uint8 string: the verdict above, and key words read by byte_key_word.
struct ByteText {
  const uint8_t* s;
  long long n_s;

  template <int NWR, class Row>
  __device__ __forceinline__ auto probe(const Row& row, int nw) const {
    return [s = s, n_s = n_s, &row, nw](long long p0) {
      return probe_bytes_verdict<NWR>(s, n_s, p0, row, nw);
    };
  }

  template <class Emit>
  __device__ __forceinline__ void read_keys(long long p0, int g0, int g1,
                                            Emit&& emit) const {
    for (int g = g0; g < g1; ++g) emit(g, byte_key_word(s, n_s, p0 + 4LL * g));
  }
};
