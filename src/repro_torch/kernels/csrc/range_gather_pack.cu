// range_gather_pack: per offset, the w symbols of a byte-per-symbol string
// packed big-endian four per 32-bit word (the byte sort keys of the
// elastic-range step), every symbol index clamped to n_s - 1.  With a row
// mask, a row whose mask byte is 0 is written as zero words and its text
// is not read (the torch.where of the elastic step, fused).
//
// Replaces the TPU kernel repro/kernels/range_gather.py:range_gather_pack
// (pallas_call at :73), which DMAs a (2, tile) window of the staged string
// per offset and packs w symbols in VMEM.
//
// Bound on the H100: memory.  A row moves 4 B of offset in and 4*nw B of
// keys out, and reads the 4*nw + 4 bytes around its symbols; offsets are
// suffix positions, so those reads are scattered 32 B sectors.  A
// 2^27-residue protein text is 134 MB, more than the 50 MB L2, so most of
// them come from device memory.
//
// Design.  A thread, or nw/4 lanes of a wide row, owns a row and reads the
// row's aligned span [off & ~3, off + 4*nw + 4) once, as aligned 32-bit
// words; each key word is one __byte_perm of two neighbouring words in
// registers (the pick of byte_key_word), so no word is read twice and no
// division runs (templates on NW in {1, 2, 4, 8, 16, 32, 64}; any other
// nw runs a loop over the row in the same file).  The output offset
// row * NW is formed once per row in 64 bits.
//  - NW 1 and 2: each thread takes ROWS rows strided by the block size and
//    issues every row's loads before it uses any, so more scattered
//    sectors are in flight; an aligned offset skips the word past its
//    keys.  The words stay 4-byte loads: an 8-byte load aligned for half
//    the rows would issue both load kinds in every warp.
//  - NW >= 4: lane l of a row writes key words 4l..4l+3 with one 16-byte
//    store, from words 4l..4l+4 of the span, read as two aligned 16-byte
//    loads and picked in registers.
// A row whose span reaches past n_s takes byte_key_word per key word, its
// clamped tail included, so results equal the plain version there too.
// Offsets (and the mask) are loaded with __ldcs and keys stored with
// __stcs, streaming past L2, so the stream does not evict text lines that
// later rows hit.  A persisting L2 window over part of the text
// (l2_window.cu) measured no faster, and its set-aside slows every other
// kernel on the card: no window is set.
#include <cuda_runtime.h>
#include <cstdint>

#include "byte_read.cuh"

// The threads a block.  launch/block_sweep.py builds this source at
// other blocks (-DERA_BLOCK_THREADS) to time them; the port builds 256.
#ifndef ERA_BLOCK_THREADS
#define ERA_BLOCK_THREADS 256
#endif
constexpr int kThreads = ERA_BLOCK_THREADS;

// __byte_perm selector of the key at byte k (0..3) of the lower word:
// result byte 3 (most significant) = memory byte k, ..., byte 0 = k + 3
__device__ __forceinline__ unsigned key_selector(int k) {
  return (unsigned)((k + 3) | ((k + 2) << 4) | ((k + 1) << 8) | (k << 12));
}

template <int NW, int ROWS>
__global__ void __launch_bounds__(kThreads) range_gather_pack_rows(
    const uint8_t* __restrict__ s, long long n_s,
    const int32_t* __restrict__ offs, long long f,
    const uint8_t* __restrict__ mask, uint32_t* __restrict__ out) {
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
  const long long row0 = (long long)blockIdx.x * (kThreads * ROWS) +
                         threadIdx.x;
  int off[ROWS];
  bool on[ROWS], fast[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + (long long)r * kThreads;
    const bool live = row < f;
    on[r] = live && (mask == nullptr || __ldcs(mask + row) != 0);
    off[r] = on[r] ? __ldcs(offs + row) : 0;
    // every word of the aligned span lies inside the string
    fast[r] = on[r] && ((long long)(off[r] & ~3) + 4 * (NW + 1) <= n_s);
  }
  uint32_t t[ROWS][NW + 1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint32_t b = (uint32_t)off[r] >> 2;
#pragma unroll
    for (int k = 0; k < NW; ++k) t[r][k] = fast[r] ? __ldg(s32 + b + k) : 0u;
    t[r][NW] = fast[r] && (off[r] & 3) ? __ldg(s32 + b + NW) : 0u;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + (long long)r * kThreads;
    if (row >= f) break;
    const unsigned sel = key_selector(off[r] & 3);
    uint32_t v[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      v[j] = fast[r] ? __byte_perm(t[r][j], t[r][j + 1], sel)
             : on[r] ? byte_key_word(s, n_s, (long long)off[r] + 4 * j)
                     : 0u;
    uint32_t* o = out + row * NW;
    if constexpr (NW == 1) {
      __stcs(o, v[0]);
    } else {
      __stcs(reinterpret_cast<uint2*>(o), make_uint2(v[0], v[1]));
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads) range_gather_pack_lanes(
    const uint8_t* __restrict__ s, long long n_s,
    const int32_t* __restrict__ offs, long long f,
    const uint8_t* __restrict__ mask, bool vec, uint32_t* __restrict__ out) {
  constexpr int LPR = NW / 4;  // lanes per row, 4 key words each
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
  const int lane = threadIdx.x & (LPR - 1);
  const long long row = (long long)blockIdx.x * (kThreads / LPR) +
                        threadIdx.x / LPR;
  if (row >= f) return;
  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (mask == nullptr || __ldcs(mask + row) != 0) {
    const int off = __ldcs(offs + row);
    const uint32_t b = ((uint32_t)off >> 2) + 4u * lane;  // first word
    const long long end = ((long long)b + 5) * 4;  // past the 5 words
    if (vec && end + 12 <= n_s) {
      // words b..b+4 lie in the two aligned 16-byte blocks at b & ~3
      const uint32_t e = b & ~3u;
      const int q = (int)(b & 3u);
      const uint4 x0 = __ldg(reinterpret_cast<const uint4*>(s32 + e));
      const uint4 x1 = __ldg(reinterpret_cast<const uint4*>(s32 + e + 4));
      const uint32_t x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      uint32_t t[5];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        t[k] = q == 0 ? x[k] : (q == 1 ? x[k + 1]
                                       : (q == 2 ? x[k + 2] : x[k + 3]));
      const unsigned sel = key_selector(off & 3);
      res = make_uint4(__byte_perm(t[0], t[1], sel),
                       __byte_perm(t[1], t[2], sel),
                       __byte_perm(t[2], t[3], sel),
                       __byte_perm(t[3], t[4], sel));
    } else {  // near the end of the string, or an unaligned string
      const long long base = (long long)off + 16LL * lane;
      res = make_uint4(byte_key_word(s, n_s, base),
                       byte_key_word(s, n_s, base + 4),
                       byte_key_word(s, n_s, base + 8),
                       byte_key_word(s, n_s, base + 12));
    }
  }
  __stcs(reinterpret_cast<uint4*>(out + row * NW + 4 * lane), res);
}

// Any other nw: one thread per row, a loop over its span.
__global__ void __launch_bounds__(kThreads) range_gather_pack_any(
    const uint8_t* __restrict__ s, long long n_s,
    const int32_t* __restrict__ offs, long long f, int nw,
    const uint8_t* __restrict__ mask, uint32_t* __restrict__ out) {
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= f) return;
  uint32_t* o = out + row * nw;
  if (mask != nullptr && __ldcs(mask + row) == 0) {
    for (int j = 0; j < nw; ++j) __stcs(o + j, 0u);
    return;
  }
  const int off = __ldcs(offs + row);
  if ((long long)(off & ~3) + 4LL * (nw + 1) > n_s) {
    for (int j = 0; j < nw; ++j)
      __stcs(o + j, byte_key_word(s, n_s, (long long)off + 4 * j));
    return;
  }
  const uint32_t b = (uint32_t)off >> 2;
  const unsigned sel = key_selector(off & 3);
  uint32_t lo = __ldg(s32 + b);
  for (int j = 0; j < nw; ++j) {
    const uint32_t hi = __ldg(s32 + b + j + 1);
    __stcs(o + j, __byte_perm(lo, hi, sel));
    lo = hi;
  }
}

// mask: uint8[f] or null.  `s` must be 4-byte aligned (the wrapper
// checks).  Returns a cudaError_t code.
extern "C" int range_gather_pack(const void* s, long long n_s,
                                 const void* offs, long long f, int nw,
                                 const void* mask, void* out, void* stream) {
  if (f <= 0) return 0;
  if (nw <= 0 || n_s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)s;
  const int32_t* o = (const int32_t*)offs;
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* dst = (uint32_t*)out;
  const bool vec = ((uintptr_t)s & 15u) == 0;
  auto grid = [f](long long rows_per_block) {
    return (unsigned)((f + rows_per_block - 1) / rows_per_block);
  };
#define RGP_ROWS(NW_, ROWS_)                                               \
  range_gather_pack_rows<NW_, ROWS_>                                       \
      <<<grid(kThreads * ROWS_), kThreads, 0, st>>>(sp, n_s, o, f, m, dst)
#define RGP_LANES(NW_)                                                     \
  range_gather_pack_lanes<NW_><<<grid(kThreads / (NW_ / 4)), kThreads, 0,  \
                                 st>>>(sp, n_s, o, f, m, vec, dst)
  switch (nw) {
    case 1: RGP_ROWS(1, 4); break;
    case 2: RGP_ROWS(2, 2); break;
    case 4: RGP_LANES(4); break;
    case 8: RGP_LANES(8); break;
    case 16: RGP_LANES(16); break;
    case 32: RGP_LANES(32); break;
    case 64: RGP_LANES(64); break;
    default:
      range_gather_pack_any<<<grid(kThreads), kThreads, 0, st>>>(
          sp, n_s, o, f, nw, m, dst);
  }
#undef RGP_ROWS
#undef RGP_LANES
  return (int)cudaGetLastError();
}
