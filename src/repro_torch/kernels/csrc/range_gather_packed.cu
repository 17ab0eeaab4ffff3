// range_gather_packed: per offset, the w symbols of the DENSE text as
// big-endian byte keys, four symbols per 32-bit word, with the terminal
// byte past n_real -- bit-identical to range_gather_pack on the
// terminal-padded byte string.  With a row mask, a row whose mask byte is
// 0 is written as zero words and its text is not read (the torch.where of
// the elastic step, fused).
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:range_gather_packed
// (pallas_call at :129), which DMAs a (2, tile) window of the staged words
// per offset, expands every field to one symbol, patches the virtual
// terminal and repacks bytes in VMEM.
//
// Bound on the H100: memory.  A row moves 4 B of offset (and 1 B of mask)
// in and 4*nw B of keys out; its ceil(nw / cpw) + 1 text words (cpw =
// 8 / bits key words per dense word) are scattered reads, offsets being
// suffix positions.  The dense text of a 2^25-symbol DNA string is 8 MiB
// and sits in the 50 MB L2.
//
// Design: the row-read of range_gather_words.cu, with a byte spread at
// the end.  A thread, or nw/4 lanes of a wide row, owns a row and reads
// the text words that hold its symbols once, funnel-shifts them in
// registers (dense_row_key) and spreads each 4*bits-bit chunk to bytes,
// patching the terminal in past n_real by position.  Templates on BITS
// (spw = 32/BITS, so off / spw and off % spw are a shift and a mask) and
// on NW in {1, 2, 4, 8, 16, 32, 64}; any other nw runs a loop over the
// row (same file, same arithmetic).  Text indices are 32-bit (offsets are
// int32); the output offset row * NW is formed once per row in 64 bits,
// so outputs past 2^31 words are right.
//  - NW 1 and 2: each thread takes ROWS rows strided by the block size
//    (coalesced offset loads and key stores) and issues every row's loads
//    before it uses any, to keep more scattered reads in flight; a row
//    skips the text word past its last symbol (at w = 4 on DNA, 13 rows
//    in 16 read one word).
//  - NW >= 4: lane l of a row writes key words 4l..4l+3 (16 symbols, bits/2
//    dense words) with one 16-byte store, from the bits/2 + 1 text words
//    that hold them; on 8-bit text these are two aligned 16-byte loads
//    picked in registers.  The lanes of a row are neighbouring threads, so
//    their overlapping words coalesce into the row's few sectors.
// Offsets (and the mask) are loaded with __ldcs and keys stored with
// __stcs, streaming past L2, so the stream does not evict the text.  Word
// indices past the array are clamped to its last word, as the plain
// version clamps them; every symbol they hold lies past n_real and is
// patched.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

// The threads a block.  launch/block_sweep.py builds this source at
// other blocks (-DERA_BLOCK_THREADS) to time them; the port builds 256.
#ifndef ERA_BLOCK_THREADS
#define ERA_BLOCK_THREADS 256
#endif
constexpr int kThreads = ERA_BLOCK_THREADS;

__device__ __forceinline__ int clamp_rem(long long n_real, int off) {
  long long r = n_real - (long long)off;
  return r < 0 ? 0 : (r > (1 << 30) ? (1 << 30) : (int)r);
}

template <int BITS, int NW, int ROWS>
__global__ void __launch_bounds__(kThreads) range_gather_packed_rows(
    const uint32_t* __restrict__ words, uint32_t last,
    const int32_t* __restrict__ offs, long long f, long long n_real,
    uint32_t t_word, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ out) {
  constexpr int LOG_SPW = BITS == 2 ? 4 : (BITS == 4 ? 3 : 2);
  constexpr int SPW = 32 / BITS;
  constexpr int CPW = 8 / BITS;               // key words per dense word
  constexpr int DW = (NW + CPW - 1) / CPW;    // dense words of a row
  const long long row0 = (long long)blockIdx.x * (kThreads * ROWS) +
                         threadIdx.x;
  int off[ROWS];
  bool on[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + (long long)r * kThreads;
    const bool live = row < f;
    on[r] = live && (mask == nullptr || __ldcs(mask + row) != 0);
    off[r] = on[r] ? __ldcs(offs + row) : 0;
  }
  uint32_t t[ROWS][DW + 1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint32_t w0 = (uint32_t)off[r] >> LOG_SPW;
    // the last text word that holds a symbol of the row: DW - 1 or DW
    const int top = ((off[r] & (SPW - 1)) + 4 * NW - 1) >> LOG_SPW;
#pragma unroll
    for (int k = 0; k <= DW; ++k) {
      const uint32_t i = w0 + k < last ? w0 + k : last;
      t[r][k] = on[r] && k <= top ? __ldg(words + i) : 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + (long long)r * kThreads;
    if (row >= f) break;
    const int sh = BITS * (off[r] & (SPW - 1));
    const int rem = clamp_rem(n_real, off[r]);
    uint32_t v[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      v[j] = on[r] ? dense_row_key<BITS>(t[r][j / CPW], t[r][j / CPW + 1],
                                         sh, j % CPW, rem - 4 * j, t_word)
                   : 0u;
    uint32_t* o = out + row * NW;
    if constexpr (NW == 1) {
      __stcs(o, v[0]);
    } else {
      __stcs(reinterpret_cast<uint2*>(o), make_uint2(v[0], v[1]));
    }
  }
}

template <int BITS, int NW>
__global__ void __launch_bounds__(kThreads) range_gather_packed_lanes(
    const uint32_t* __restrict__ words, uint32_t last,
    const int32_t* __restrict__ offs, long long f, long long n_real,
    uint32_t t_word, const uint8_t* __restrict__ mask, bool vec,
    uint32_t* __restrict__ out) {
  constexpr int LOG_SPW = BITS == 2 ? 4 : (BITS == 4 ? 3 : 2);
  constexpr int SPW = 32 / BITS;
  constexpr int CPW = 8 / BITS;   // key words per dense word
  constexpr int DWL = BITS / 2;   // dense words of a lane's 16 symbols
  constexpr int LPR = NW / 4;     // lanes per row, 4 key words each
  const int lane = threadIdx.x & (LPR - 1);
  const long long row = (long long)blockIdx.x * (kThreads / LPR) +
                        threadIdx.x / LPR;
  if (row >= f) return;
  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (mask == nullptr || __ldcs(mask + row) != 0) {
    const int off = __ldcs(offs + row);
    const uint32_t w0 = ((uint32_t)off >> LOG_SPW) + DWL * lane;
    uint32_t t[DWL + 1];
    bool done = false;
    if constexpr (DWL == 4) {
      if (vec && w0 + 7u <= last) {
        // words w0..w0+4 lie in the two aligned 16-byte blocks at w0 & ~3
        const uint32_t e = w0 & ~3u;
        const int q = (int)(w0 & 3u);
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(words + e));
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(words + e + 4));
        const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int k = 0; k < 5; ++k)
          t[k] = q == 0 ? x[k] : (q == 1 ? x[k + 1]
                                         : (q == 2 ? x[k + 2] : x[k + 3]));
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int k = 0; k <= DWL; ++k)
        t[k] = __ldg(words + (w0 + k < last ? w0 + k : last));
    }
    const int sh = BITS * (off & (SPW - 1));
    const int rem = clamp_rem(n_real, off) - 16 * lane;
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      v[m] = dense_row_key<BITS>(t[m / CPW], t[m / CPW + 1], sh, m % CPW,
                                 rem - 4 * m, t_word);
    res = make_uint4(v[0], v[1], v[2], v[3]);
  }
  __stcs(reinterpret_cast<uint4*>(out + row * NW + 4 * lane), res);
}

// Any other nw: one thread per row, a loop over its key words.
template <int BITS>
__global__ void __launch_bounds__(kThreads) range_gather_packed_any(
    const uint32_t* __restrict__ words, uint32_t last,
    const int32_t* __restrict__ offs, long long f, int nw, long long n_real,
    uint32_t t_word, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ out) {
  constexpr int LOG_SPW = BITS == 2 ? 4 : (BITS == 4 ? 3 : 2);
  constexpr int SPW = 32 / BITS;
  constexpr int CPW = 8 / BITS;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= f) return;
  uint32_t* o = out + row * nw;
  if (mask != nullptr && __ldcs(mask + row) == 0) {
    for (int j = 0; j < nw; ++j) __stcs(o + j, 0u);
    return;
  }
  const int off = __ldcs(offs + row);
  const uint32_t w0 = (uint32_t)off >> LOG_SPW;
  const int sh = BITS * (off & (SPW - 1));
  const int rem = clamp_rem(n_real, off);
  uint32_t hi = __ldg(words + (w0 < last ? w0 : last));
  uint32_t lo = __ldg(words + (w0 + 1 < last ? w0 + 1 : last));
  for (int j = 0; j < nw; ++j) {
    const int c = j % CPW;
    if (c == 0 && j > 0) {  // the next dense word of the row
      const uint32_t i = w0 + j / CPW + 1;
      hi = lo;
      lo = __ldg(words + (i < last ? i : last));
    }
    __stcs(o + j, dense_row_key<BITS>(hi, lo, sh, c, rem - 4 * j, t_word));
  }
}

template <int BITS>
static void launch(const uint32_t* words, uint32_t last, const int32_t* offs,
                   long long f, int nw, long long n_real, uint32_t t_word,
                   const uint8_t* mask, bool vec, uint32_t* out,
                   cudaStream_t st) {
  auto grid = [f](long long rows_per_block) {
    return (unsigned)((f + rows_per_block - 1) / rows_per_block);
  };
#define RGK_ROWS(NW_, ROWS_)                                               \
  range_gather_packed_rows<BITS, NW_, ROWS_>                               \
      <<<grid(kThreads * ROWS_), kThreads, 0, st>>>(                       \
          words, last, offs, f, n_real, t_word, mask, out)
#define RGK_LANES(NW_)                                                     \
  range_gather_packed_lanes<BITS, NW_>                                     \
      <<<grid(kThreads / (NW_ / 4)), kThreads, 0, st>>>(                   \
          words, last, offs, f, n_real, t_word, mask, vec, out)
  switch (nw) {
    case 1: RGK_ROWS(1, 4); break;
    case 2: RGK_ROWS(2, 2); break;
    case 4: RGK_LANES(4); break;
    case 8: RGK_LANES(8); break;
    case 16: RGK_LANES(16); break;
    case 32: RGK_LANES(32); break;
    case 64: RGK_LANES(64); break;
    default:
      range_gather_packed_any<BITS><<<grid(kThreads), kThreads, 0, st>>>(
          words, last, offs, f, nw, n_real, t_word, mask, out);
  }
#undef RGK_ROWS
#undef RGK_LANES
}

// t_word: the terminal code in every byte.  mask: uint8[f] or null.
// Returns a cudaError_t code.
extern "C" int range_gather_packed(const void* words, long long n_words,
                                   const void* offs, long long f, int nw,
                                   int bits, long long n_real,
                                   unsigned int t_word, const void* mask,
                                   void* out, void* stream) {
  if (f <= 0) return 0;
  if (nw <= 0 || n_words <= 0 || (bits != 2 && bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t last = (uint32_t)(n_words - 1 < 0xFFFFFFFFLL
                                       ? n_words - 1 : 0xFFFFFFFFLL);
  const bool vec = ((uintptr_t)words & 15u) == 0;
  const uint32_t* w = (const uint32_t*)words;
  const int32_t* o = (const int32_t*)offs;
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* dst = (uint32_t*)out;
  if (bits == 2)
    launch<2>(w, last, o, f, nw, n_real, t_word, m, vec, dst, st);
  else if (bits == 4)
    launch<4>(w, last, o, f, nw, n_real, t_word, m, vec, dst, st);
  else
    launch<8>(w, last, o, f, nw, n_real, t_word, m, vec, dst, st);
  return (int)cudaGetLastError();
}
