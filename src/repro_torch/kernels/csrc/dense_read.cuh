// Shared device helpers of the dense-text kernels: one shift-aligned,
// terminal-substituted dense word of the text (the in-kernel form of
// repro_torch.core.packing.gather_words_dense), and the byte key words
// spread from it (the in-kernel form of packing.gather_pack_dense).
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

// The row-wise form of dense_read_word for a kernel that has already read
// the row's text words: `hi` and `lo` are the words that straddle output
// word j, `sh` = BITS * (off % spw), and `rem` the real symbols the row
// has left at output word 0 (n_real - off, clamped to [0, 2^30]).
template <int BITS>
__device__ __forceinline__ uint32_t dense_row_word(uint32_t hi, uint32_t lo,
                                                   int sh, int rem, int j,
                                                   uint32_t sub_word) {
  constexpr int SPW = 32 / BITS;
  uint32_t aligned = __funnelshift_l(lo, hi, sh);
  int v = rem - SPW * j;
  v = v < 0 ? 0 : (v > SPW ? SPW : v);
  uint32_t keep = v > 0 ? (0xFFFFFFFFu << ((SPW - v) * BITS)) : 0u;
  return (aligned & keep) | (sub_word & ~keep);
}

// 4 right-aligned bits-wide fields of c -> the 4 big-endian bytes of a word
// (the bit interleave of repro_torch.core.packing._spread_to_bytes).
__device__ __forceinline__ uint32_t spread_to_bytes(uint32_t c, int bits) {
  if (bits == 4) {
    uint32_t t = (c | (c << 8)) & 0x00FF00FFu;
    return (t | (t << 4)) & 0x0F0F0F0Fu;
  }
  if (bits == 2) {
    uint32_t t = (c | (c << 12)) & 0x000F000Fu;
    return (t | (t << 6)) & 0x03030303u;
  }
  return c;  // bits == 8: the dense word is already one key word
}

// Byte key word j of the read at symbol offset p0, from `aligned`, the
// shift-aligned dense word j / (8 / bits) of that read (dense_read_word
// with sub_word 0): its 4*bits-bit chunk j % (8 / bits) spread to bytes,
// with the terminal byte (t_word holds it in every byte) patched in at
// every position >= n_real.  Equal to the key word gather_pack reads from
// the terminal-padded byte string.
__device__ __forceinline__ uint32_t dense_key_word(uint32_t aligned, int j,
                                                   int bits, long long p0,
                                                   long long n_real,
                                                   uint32_t t_word) {
  const int cpw = 8 / bits;  // key words per dense word
  const int cbits = 4 * bits;
  const int c = j % cpw;
  uint32_t chunk = cpw > 1
      ? (aligned >> (32 - cbits * (c + 1))) & ((1u << cbits) - 1u)
      : aligned;
  uint32_t key = spread_to_bytes(chunk, bits);
  long long real = n_real - (p0 + 4LL * j);  // real symbols in the word
  uint32_t keep = real >= 4 ? 0xFFFFFFFFu
                  : real <= 0 ? 0u
                              : 0xFFFFFFFFu << (8 * (4 - (int)real));
  return (key & keep) | (t_word & ~keep);
}
