// range_gather_words: per offset, nw = ceil(w/spw) shift-aligned dense
// words of the text with the virtual terminal substituted past n_real.
// With a row mask, a row whose mask byte is 0 is written as nw zero words
// and its text is not read (the torch.where of the elastic step, fused).
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:range_gather_words
// (pallas_call at :295), which DMAs a (2, tile) window of staged text rows
// per offset.
//
// Bound on the H100: memory.  A row moves 4 B of offset in and 4*nw B of
// keys out; its nw + 1 text words are scattered reads (offsets are suffix
// positions), served by L2 when the text fits there (the dense text of a
// 2^27-symbol DNA string is 32 MiB, the L2 50 MB).
//
// Design.  A thread, or nw/4 lanes of a wide row, owns a row and reads
// its nw + 1 consecutive text words once, then funnel-shifts them in
// registers (dense_row_word), so no text word is read twice and no
// division runs: the kernel is templated on BITS (spw = 32/BITS, so
// off / spw and off % spw are a shift and a mask) and on NW in
// {1, 2, 4, 8, 16, 32, 64}; any other nw runs a loop over the row (same
// file, same arithmetic).  Text indices are 32-bit (offsets are int32);
// the output offset row * NW is formed once per row in 64 bits, so
// outputs past 2^31 words are right.
//  - NW 1 and 2: each thread takes ROWS rows strided by the block size
//    (coalesced offset loads and key stores) and issues every row's loads
//    before it uses any, to keep more scattered reads in flight.  The two
//    or three words of a row share a 32 B sector most of the time; they
//    stay 4-byte loads, since an 8-byte load aligned for half the rows
//    would issue both load kinds in every warp.
//  - NW >= 4: lane l of a row writes output words 4l..4l+3 with one
//    16-byte store, from words 4l..4l+4 of the row, read as two aligned
//    16-byte loads and picked in registers.
// Offsets (and the mask) are loaded with __ldcs and keys stored with
// __stcs, streaming past L2, so the stream does not evict the text.  A
// persisting L2 window over the text (l2_window.cu) measured slower, and
// its set-aside slows every other kernel on the card: no window is set.
// Word indices past the array are clamped to its last word, as the plain
// version clamps them.
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
__global__ void __launch_bounds__(kThreads) range_gather_words_rows(
    const uint32_t* __restrict__ words, uint32_t last,
    const int32_t* __restrict__ offs, long long f, long long n_real,
    uint32_t sub_word, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ out) {
  constexpr int LOG_SPW = BITS == 2 ? 4 : (BITS == 4 ? 3 : 2);
  constexpr int SPW = 32 / BITS;
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
  uint32_t t[ROWS][NW + 1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint32_t w0 = (uint32_t)off[r] >> LOG_SPW;
#pragma unroll
    for (int k = 0; k <= NW; ++k) {
      const uint32_t i = w0 + k < last ? w0 + k : last;
      t[r][k] = on[r] ? __ldg(words + i) : 0u;
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
      v[j] = on[r] ? dense_row_word<BITS>(t[r][j], t[r][j + 1], sh, rem, j,
                                          sub_word)
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
__global__ void __launch_bounds__(kThreads) range_gather_words_lanes(
    const uint32_t* __restrict__ words, uint32_t last,
    const int32_t* __restrict__ offs, long long f, long long n_real,
    uint32_t sub_word, const uint8_t* __restrict__ mask, bool vec,
    uint32_t* __restrict__ out) {
  constexpr int LOG_SPW = BITS == 2 ? 4 : (BITS == 4 ? 3 : 2);
  constexpr int SPW = 32 / BITS;
  constexpr int LPR = NW / 4;  // lanes per row, 4 output words each
  const int lane = threadIdx.x & (LPR - 1);
  const long long row = (long long)blockIdx.x * (kThreads / LPR) +
                        threadIdx.x / LPR;
  if (row >= f) return;
  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (mask == nullptr || __ldcs(mask + row) != 0) {
    const int off = __ldcs(offs + row);
    const uint32_t w0 = ((uint32_t)off >> LOG_SPW) + 4u * lane;
    uint32_t t[5];
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
    } else {
#pragma unroll
      for (int k = 0; k < 5; ++k)
        t[k] = __ldg(words + (w0 + k < last ? w0 + k : last));
    }
    const int sh = BITS * (off & (SPW - 1));
    const int rem = clamp_rem(n_real, off) - SPW * 4 * lane;
    res.x = dense_row_word<BITS>(t[0], t[1], sh, rem, 0, sub_word);
    res.y = dense_row_word<BITS>(t[1], t[2], sh, rem, 1, sub_word);
    res.z = dense_row_word<BITS>(t[2], t[3], sh, rem, 2, sub_word);
    res.w = dense_row_word<BITS>(t[3], t[4], sh, rem, 3, sub_word);
  }
  __stcs(reinterpret_cast<uint4*>(out + row * NW + 4 * lane), res);
}

// Any other nw: one thread per row, a loop over its words.
template <int BITS>
__global__ void __launch_bounds__(kThreads) range_gather_words_any(
    const uint32_t* __restrict__ words, uint32_t last,
    const int32_t* __restrict__ offs, long long f, int nw, long long n_real,
    uint32_t sub_word, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ out) {
  constexpr int LOG_SPW = BITS == 2 ? 4 : (BITS == 4 ? 3 : 2);
  constexpr int SPW = 32 / BITS;
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
  for (int j = 0; j < nw; ++j) {
    const uint32_t i = w0 + j + 1;
    const uint32_t lo = __ldg(words + (i < last ? i : last));
    __stcs(o + j, dense_row_word<BITS>(hi, lo, sh, rem, j, sub_word));
    hi = lo;
  }
}

template <int BITS>
static void launch(const uint32_t* words, uint32_t last, const int32_t* offs,
                   long long f, int nw, long long n_real, uint32_t sub_word,
                   const uint8_t* mask, bool vec, uint32_t* out,
                   cudaStream_t st) {
  auto grid = [f](long long rows_per_block) {
    return (unsigned)((f + rows_per_block - 1) / rows_per_block);
  };
#define RGW_ROWS(NW_, ROWS_)                                               \
  range_gather_words_rows<BITS, NW_, ROWS_>                                \
      <<<grid(kThreads * ROWS_), kThreads, 0, st>>>(                       \
          words, last, offs, f, n_real, sub_word, mask, out)
#define RGW_LANES(NW_)                                                     \
  range_gather_words_lanes<BITS, NW_>                                      \
      <<<grid(kThreads / (NW_ / 4)), kThreads, 0, st>>>(                   \
          words, last, offs, f, n_real, sub_word, mask, vec, out)
  switch (nw) {
    case 1: RGW_ROWS(1, 4); break;
    case 2: RGW_ROWS(2, 2); break;
    case 4: RGW_LANES(4); break;
    case 8: RGW_LANES(8); break;
    case 16: RGW_LANES(16); break;
    case 32: RGW_LANES(32); break;
    case 64: RGW_LANES(64); break;
    default:
      range_gather_words_any<BITS><<<grid(kThreads), kThreads, 0, st>>>(
          words, last, offs, f, nw, n_real, sub_word, mask, out);
  }
#undef RGW_ROWS
#undef RGW_LANES
}

// mask: uint8[f] or null.  Returns a cudaError_t code.
extern "C" int range_gather_words(const void* words, long long n_words,
                                  const void* offs, long long f, int nw,
                                  int bits, long long n_real,
                                  unsigned int sub_word, const void* mask,
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
  if (bits == 2)
    launch<2>(w, last, o, f, nw, n_real, sub_word, m, vec, (uint32_t*)out, st);
  else if (bits == 4)
    launch<4>(w, last, o, f, nw, n_real, sub_word, m, vec, (uint32_t*)out, st);
  else
    launch<8>(w, last, o, f, nw, n_real, sub_word, m, vec, (uint32_t*)out, st);
  return (int)cudaGetLastError();
}
