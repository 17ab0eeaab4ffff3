// Shared device helpers of the word-compare probes: the -1/0/+1 verdict of
// one masked dense pattern row against the suffix at p0, by XOR, first
// differing word, clz and the terminal-limit rules of
// repro_torch.kernels.ref.probe_words_ref.  pattern_probe_words.cu (one
// search step), search_bounds_words.cu (the whole search),
// probe_gather_words.cu (the fused probe + gather) and
// search_fetch_words.cu (search and find-and-fetch in one launch) decide
// with this code.
#pragma once
#include <cstdint>

#include "dense_read.cuh"

// A pattern row read from device memory (row-major, nw words a row).
struct GlobalRow {
  const uint32_t* __restrict__ pat;
  const uint32_t* __restrict__ mask;
  __device__ __forceinline__ uint32_t p(int j) const { return pat[j]; }
  __device__ __forceinline__ uint32_t m(int j) const { return mask[j]; }
};

// A pattern row held in registers: N words, filled once per row.  Only
// constant indices reach it (the compare loops unroll over N), so it
// stays out of local memory.
template <int N>
struct RegRow {
  uint32_t pat[N];
  uint32_t mask[N];
  __device__ __forceinline__ uint32_t p(int j) const { return pat[j]; }
  __device__ __forceinline__ uint32_t m(int j) const { return mask[j]; }
};

// A pattern row staged in shared memory, word j at [j * stride] (threads
// of a block interleave their rows, so a warp's reads of word j hit
// distinct banks).
struct SharedRow {
  const uint32_t* pat;
  const uint32_t* mask;
  int stride;
  __device__ __forceinline__ uint32_t p(int j) const {
    return pat[j * stride];
  }
  __device__ __forceinline__ uint32_t m(int j) const {
    return mask[j * stride];
  }
};

// The verdict from the first difference: p the symbol index of the first
// differing symbol (nw * spw when none), aw / bw the masked suffix and
// pattern words that hold it, sym its index inside them.  Limits at or
// past the compare length saturate out of the comparison.
__device__ __forceinline__ int probe_words_resolve(
    long long p, int sym, uint32_t aw, uint32_t bw, int bits, long long big,
    long long cmp_len, long long ls, long long lp) {
  const uint32_t ones = (1u << bits) - 1u;
  int sh = 32 - bits * (sym + 1);
  int ca = (int)((aw >> sh) & ones);
  int cb = (int)((bw >> sh) & ones);
  int sym_sign = ca < cb ? -1 : 1;
  ls = ls < cmp_len ? ls : big;
  lp = lp < cmp_len ? lp : big;
  int lim_sign = ls < lp ? 1 : (lp < ls ? -1 : 0);
  long long lim = ls < lp ? ls : lp;
  return p < lim ? sym_sign : lim_sign;
}

// The verdict of the pattern row `row` (nw words) against the suffix at
// p0: the text words are read in order and the walk stops at the first
// word whose masked XOR is nonzero.  NWR > 0 unrolls the walk over NWR
// words (nw <= NWR), as a register row needs; NWR == 0 walks nw words.
template <int NWR, class Row>
__device__ __forceinline__ int probe_words_verdict(
    const uint32_t* __restrict__ words, long long n_words, long long p0,
    const Row& row, int nw, int bits, long long n_real, uint32_t sub_word,
    long long cmp_len, long long lim_p) {
  const int spw = 32 / bits;
  const long long big = (long long)nw * spw;
  long long p = big;
  int sym = 0;
  uint32_t aw = 0, bw = 0;
#pragma unroll
  for (int j = 0; j < (NWR > 0 ? NWR : nw); ++j) {
    if (NWR > 0 && j >= nw) break;
    uint32_t sw = dense_read_word(words, n_words, p0, j, bits, spw, n_real,
                                  sub_word) & row.m(j);
    uint32_t pw = row.p(j);
    uint32_t x = sw ^ pw;
    if (x != 0u) {
      sym = __clz((int)x) / bits;
      p = (long long)j * spw + sym;
      aw = sw;
      bw = pw;
      break;
    }
  }
  return probe_words_resolve(p, sym, aw, bw, bits, big, cmp_len, n_real - p0,
                             lim_p);
}
