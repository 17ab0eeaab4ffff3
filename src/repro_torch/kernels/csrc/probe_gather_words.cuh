// Shared device code of the fused find-and-fetch over dense words: the
// per-row compare-and-read of probe_gather_words.cu, also run by the lower
// lane of each pattern in search_fetch_words.cu.
#pragma once
#include <cstdint>

#include "dense_read.cuh"
#include "probe_words.cuh"

// The verdict of the pattern row `row` (nw_pat words) against the suffix
// at p0 AND window words 0 .. nw_out - 1 of the read there, each text word
// read once (dense_read.cuh: shift-aligned, sub_word substituted past
// n_real): emit(j, w) receives window word j, the first nw_pat words feed
// the compare of probe_words.cuh (masked XOR, first differing word, __clz
// / bits, then probe_words_resolve with both terminal limits) until it
// has found its difference.  The read stops once the window is written
// and the verdict decided.  NWR > 0 unrolls the compare over NWR words
// (nw_pat <= NWR), as a register row needs; NWR == 0 walks nw_pat words.
template <int NWR, class Row, class Emit>
__device__ __forceinline__ int probe_gather_words_row(
    const uint32_t* __restrict__ words, long long n_words, long long p0,
    const Row& row, int nw_pat, int nw_out, int bits, long long n_real,
    uint32_t sub_word, long long cmp_len, long long lim_p, Emit&& emit) {
  const int spw = 32 / bits;
  const long long big = (long long)nw_pat * spw;
  long long p = big;
  int sym = 0;
  uint32_t aw = 0, bw = 0;
  bool open = true;  // no differing word found yet
  int j = 0;
#pragma unroll
  for (int jj = 0; jj < (NWR > 0 ? NWR : nw_pat); ++jj) {
    if (NWR > 0 && jj >= nw_pat) break;
    if (jj >= nw_out && !open) break;  // window written, verdict decided
    const uint32_t w = dense_read_word(words, n_words, p0, jj, bits, spw,
                                       n_real, sub_word);
    if (jj < nw_out) emit(jj, w);
    if (open) {
      const uint32_t sw = w & row.m(jj);
      const uint32_t pw = row.p(jj);
      const uint32_t x = sw ^ pw;
      if (x != 0u) {
        sym = __clz((int)x) / bits;
        p = (long long)jj * spw + sym;
        aw = sw;
        bw = pw;
        open = false;
      }
    }
    j = jj + 1;
  }
  // the window's words past the pattern (none when the loop broke early:
  // then nw_out <= j)
  for (; j < nw_out; ++j)
    emit(j, dense_read_word(words, n_words, p0, j, bits, spw, n_real,
                            sub_word));
  return probe_words_resolve(p, sym, aw, bw, bits, big, cmp_len, n_real - p0,
                             lim_p);
}
