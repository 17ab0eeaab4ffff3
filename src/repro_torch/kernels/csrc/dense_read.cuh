// Shared device helper of the word-currency kernels: one shift-aligned,
// terminal-substituted dense word of the text (the in-kernel form of
// repro_torch.core.packing.gather_words_dense).
#pragma once
#include <cstdint>

// Word j (0-based) of the read at symbol offset `off` (off >= 0): the
// 32 bits covering symbols off + spw*j .. off + spw*j + spw - 1, with
// sub_word's fields substituted for every position >= n_real.  Word
// indices past the array are clamped to its last word, as the plain
// version does; those fields are always substituted.
__device__ __forceinline__ uint32_t dense_read_word(
    const uint32_t* __restrict__ words, long long n_words, long long off,
    int j, int bits, int spw, long long n_real, uint32_t sub_word) {
  long long w0 = off / spw + j;
  long long i0 = w0 < n_words - 1 ? w0 : n_words - 1;
  long long i1 = w0 + 1 < n_words - 1 ? w0 + 1 : n_words - 1;
  uint32_t hi = __ldg(words + i0);
  uint32_t lo = __ldg(words + i1);
  int sh = bits * (int)(off % spw);
  // top 32 bits of (hi:lo) << sh; sh == 0 returns hi unchanged
  uint32_t aligned = __funnelshift_l(lo, hi, sh);
  long long v = n_real - (off + (long long)spw * j);
  v = v < 0 ? 0 : (v > spw ? spw : v);
  uint32_t keep = v > 0 ? (0xFFFFFFFFu << ((spw - (int)v) * bits)) : 0u;
  return (aligned & keep) | (sub_word & ~keep);
}
