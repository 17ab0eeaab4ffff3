// Shared device code of the byte-key probes over the DENSE text: byte key
// words read from the shift-aligned dense words at a suffix, the -1/0/+1
// verdict of a masked pattern row against them (compared unsigned at the
// first differing word, C5), and the key words of a window.
// pattern_probe_packed.cu (one search step), probe_gather_packed.cu (the
// step with its window), search_bounds_packed.cu (the whole search) and
// search_fetch_packed.cu (search and find-and-fetch in one launch; both
// through the DenseText policy of search.cuh's kernels) decide with this
// code, so their verdicts are the same bit for bit.  Row types
// (GlobalRow, RegRow, SharedRow) are those of probe_words.cuh.
#pragma once
#include <cstdint>

#include "dense_read.cuh"
#include "probe_words.cuh"

namespace packed {

// A read of byte key words at symbol offset p0 >= 0 of a text of BITS-bit
// fields.  Key word j holds symbols p0 + 4j .. p0 + 4j + 3: chunk j % CPW
// of the shift-aligned dense word j / CPW, spread to bytes, with the
// terminal byte at every position >= n_real (dense_row_key).  Key words
// are made a chunk of KC at a time: every dense word the chunk's wanted
// key words need is loaded before the first of them is made, so a chunk
// costs one round trip, not a chain of them.
template <int BITS>
struct Read {
  static constexpr int SPW = 32 / BITS;  // symbols per dense word
  static constexpr int CPW = 8 / BITS;   // key words per dense word
  static constexpr int KC = 4 * CPW > 8 ? 4 * CPW : 8;  // 16, 8, 8
  static constexpr int RAW = KC / CPW + 1;  // dense words under a chunk

  long long w0;  // the dense word that holds symbol p0
  int sh;        // BITS * (p0 % SPW): the funnel shift
  int rem;       // real symbols from p0 on, clamped to [0, 2^30]

  __device__ __forceinline__ Read(long long p0, long long n_real)
      : w0(p0 / SPW), sh(BITS * (int)(p0 % SPW)) {
    const long long r = n_real - p0;
    rem = r < 0 ? 0 : (r > (1LL << 30) ? (1 << 30) : (int)r);
  }

  // The dense words of the chunk that starts at key word j0 (a multiple
  // of CPW) for its key words in [g0, g1): raw[t] is word w0 + j0 / CPW +
  // t, clamped to the last word (C12).  A word that holds none of the
  // wanted key words' symbols is left 0 and not loaded.
  __device__ __forceinline__ void load(const uint32_t* __restrict__ words,
                                       long long n_words, int j0, int g0,
                                       int g1, uint32_t (&raw)[RAW]) const {
    // chunk-relative key words [beg, end); the chunk's symbols start at
    // offset sh / BITS of its first dense word
    const int beg = g0 > j0 ? g0 - j0 : 0;
    const int end = g1 - j0 < KC ? g1 - j0 : KC;
    const int first = (sh / BITS + 4 * beg) / SPW;
    const int last = end > beg ? (sh / BITS + 4 * end - 1) / SPW : -1;
    const long long base = w0 + j0 / CPW;
#pragma unroll
    for (int t = 0; t < RAW; ++t) {
      const long long w = base + t < n_words - 1 ? base + t : n_words - 1;
      raw[t] = (t >= first && t <= last) ? __ldg(words + w) : 0u;
    }
  }

  // Key word j = j0 + jj of the read, from its chunk's dense words;
  // t_word holds the terminal byte in every byte.
  __device__ __forceinline__ uint32_t key(const uint32_t (&raw)[RAW], int jj,
                                          int j, uint32_t t_word) const {
    const int t = jj / CPW;
    return dense_row_key<BITS>(raw[t], raw[t + 1], sh, jj % CPW, rem - 4 * j,
                               t_word);
  }
};

// One past the last nonzero mask word of a pattern row: the key words
// from there on compare 0 against the pattern and read no text.
template <int NWR, class Row>
__device__ __forceinline__ int live_words(const Row& row, int nw) {
  int live = 0;
#pragma unroll
  for (int j = 0; j < (NWR > 0 ? NWR : nw); ++j) {
    if (NWR > 0 && j >= nw) break;
    if (row.m(j)) live = j + 1;
  }
  return live;
}

// The verdict of the pattern row `row` (nw key words, the first `live`
// of them with a nonzero mask: live_words) against the suffix at p0: the
// suffix's masked key words against the pattern's, unsigned, stopping at
// the first that differs (0: the suffix starts with the pattern).  A
// chunk's dense words are all loaded before its first compare, and the
// walk leaves after the chunk that decides.  NWR > 0 unrolls the walk over
// NWR words (nw <= NWR), as a register row needs; NWR == 0 walks nw.
template <int BITS, int NWR, class Row>
__device__ __forceinline__ int probe_packed_verdict(
    const uint32_t* __restrict__ words, long long n_words, long long p0,
    const Row& row, int nw, int live, long long n_real, uint32_t t_word) {
  using R = Read<BITS>;
  constexpr int KI = NWR > 0 && NWR < R::KC ? NWR : R::KC;  // a chunk
  const R rd(p0, n_real);
  int v = 0;
#pragma unroll
  for (int j0 = 0; j0 < (NWR > 0 ? NWR : nw); j0 += KI) {
    if (NWR > 0 && j0 >= nw) break;
    uint32_t raw[R::RAW];
    rd.load(words, n_words, j0, 0, live, raw);
#pragma unroll
    for (int jj = 0; jj < KI; ++jj) {
      const int j = j0 + jj;
      if (j >= nw) break;
      const uint32_t m = row.m(j);
      const uint32_t sw = m ? (rd.key(raw, jj, j, t_word) & m) : 0u;
      const uint32_t pw = row.p(j);
      if (sw != pw) {
        v = sw < pw ? -1 : 1;
        break;
      }
    }
    if (v) break;
  }
  return v;
}

// Key words [g0, g1) of the read at p0, a chunk at a time: emit(g, key).
template <int BITS, class Emit>
__device__ __forceinline__ void read_keys(const uint32_t* __restrict__ words,
                                          long long n_words, long long p0,
                                          long long n_real, int g0, int g1,
                                          uint32_t t_word, Emit&& emit) {
  using R = Read<BITS>;
  const R rd(p0, n_real);
  for (int j0 = g0 / R::KC * R::KC; j0 < g1; j0 += R::KC) {
    uint32_t raw[R::RAW];
    rd.load(words, n_words, j0, g0, g1, raw);
#pragma unroll
    for (int jj = 0; jj < R::KC; ++jj) {
      const int g = j0 + jj;
      if (g >= g0 && g < g1) emit(g, rd.key(raw, jj, g, t_word));
    }
  }
}

// The Text policy of search.cuh's byte-key kernels on the dense text of
// BITS-bit fields: the verdict and the key words above.
template <int BITS>
struct DenseText {
  const uint32_t* words;
  long long n_words;
  long long n_real;
  uint32_t t_word;  // the terminal byte in every byte

  template <int NWR, class Row>
  __device__ __forceinline__ auto probe(const Row& row, int nw) const {
    const int live = live_words<NWR>(row, nw);
    return [t = *this, &row, nw, live](long long p0) {
      return probe_packed_verdict<BITS, NWR>(t.words, t.n_words, p0, row, nw,
                                             live, t.n_real, t.t_word);
    };
  }

  template <class Emit>
  __device__ __forceinline__ void read_keys(long long p0, int g0, int g1,
                                            Emit&& emit) const {
    packed::read_keys<BITS>(words, n_words, p0, n_real, g0, g1, t_word,
                            emit);
  }
};

}  // namespace packed
