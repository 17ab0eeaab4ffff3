// suffix_lcp_pairs: per pair (pos_a, pos_b), the index of the first
// unequal symbol of the two suffixes of a byte-per-symbol string within w
// symbols (w % 4 == 0), or w when they agree that far.  Every symbol index
// is clamped to n_s - 1, as gather_pack clamps.
//
// Replaces the TPU kernel repro/kernels/suffix_lcp.py:suffix_lcp_pairs
// (pallas_call at :80), which DMAs two (2, tile) windows of the staged
// string per pair and takes an iota-min over the w unequal symbols.
//
// Bound on the H100: memory, and in practice the latency of scattered
// 32-byte sectors.  A pair reads its two positions, writes one int32 and
// touches the text up to its first difference; a 2^27-residue text is
// 134 MB, more than the 50 MB L2, so each window is a device-memory
// sector.  The design is suffix_lcp_words.cu's on byte keys:
//
// * Chunked reads, early exit per chunk.  A thread per pair reads a
//   suffix's key words in chunks of 4 (16 symbols; fewer for NW < 4),
//   each chunk from the two aligned 16-byte loads that cover its 19
//   bytes, picked and byte-swapped by __byte_perm, and compares a chunk
//   whole before it reads the next.  A pair that differs in its first
//   word reads no more sectors than a word-at-a-time loop, and a long
//   common prefix pays one dependent round trip per 16 symbols, not per 4.
// * The clamp.  A chunk whose aligned 32 bytes reach past n_s takes
//   byte_key_word per key word (byte_read.cuh), its clamped tail
//   included, so results equal the plain version there too.
// * One read per shared suffix.  Adjacent leaves (the node build's pairs,
//   and consecutive pending pairs of later lcp_from_text rounds) share a
//   suffix: pos_a[i] == pos_b[i - 1].  Each lane reads its pos_b suffix;
//   one __shfl_up_sync of pos_b tells a lane that its pos_a suffix is its
//   neighbour's, and then it takes those key words by shuffle, chunk by
//   chunk, instead of reading the text.  The exchange runs in lock-step
//   chunks while either lane still needs words: a lane whose own pair is
//   decided keeps reading its pos_b chunks while its neighbour needs them.
//   Lane 0 of a warp, a lane whose neighbour differs, and the analytics'
//   boundary pairs read their pos_a suffix themselves.
// * Templates on the NW bucket (w/4 in 1, 2, 4, 8, 16, 32, 64; any other
//   width takes the runtime-nw instantiation); 32-bit positions.
//   Positions stream in through __ldcs and results out through __stcs.
// Codes >= 128 need no care: only equality and the first unequal byte
// are read, by XOR and __clz.  `s` must be 16-byte aligned (the wrapper
// checks and raises).
#include <cuda_runtime.h>

#include <cstdint>

#include "byte_read.cuh"

static constexpr unsigned FULL = 0xFFFFFFFFu;

// __byte_perm selector of the key at byte k (0..3) of the lower word:
// result byte 3 (most significant) = memory byte k, ..., byte 0 = k + 3
__device__ __forceinline__ unsigned key_selector(unsigned k) {
  return (k + 3) | ((k + 2) << 4) | ((k + 1) << 8) | (k << 12);
}

// Key words j0 .. j0 + C - 1 of the suffix at `p`: the big-endian keys of
// symbols p + 4*j0 .. p + 4*(j0 + C) - 1, each index clamped to n_s - 1.
template <int C>
__device__ __forceinline__ void read_keys(const uint8_t* __restrict__ s,
                                          long long n_s, uint32_t p, int j0,
                                          uint32_t (&o)[C]) {
  const uint32_t base = p + 4u * (uint32_t)j0;  // first symbol of the chunk
  const unsigned sel = key_selector(base & 3u);
  uint32_t t[C + 1];
  bool inside;
  if constexpr (C == 4) {
    // symbols base .. base + 15 lie in the 32 bytes at base & ~15
    const uint32_t g0 = base & ~15u;
    inside = (long long)g0 + 32 <= n_s;
    if (inside) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(s + g0));
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(s + g0 + 16));
      const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      const int d = (int)((base >> 2) & 3u);
#pragma unroll
      for (int m = 0; m <= C; ++m)
        t[m] = d == 0 ? v[m] : d == 1 ? v[m + 1] : d == 2 ? v[m + 2]
                                                         : v[m + 3];
    }
  } else {
    // symbols base .. base + 4C - 1 lie in the C + 1 words at base & ~3
    const uint32_t g0 = base & ~3u;
    inside = (long long)g0 + 4 * (C + 1) <= n_s;
    if (inside) {
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s + g0);
#pragma unroll
      for (int m = 0; m <= C; ++m) t[m] = __ldg(s32 + m);
    }
  }
  if (inside) {
#pragma unroll
    for (int m = 0; m < C; ++m) o[m] = __byte_perm(t[m], t[m + 1], sel);
  } else {  // near the end of the string: the clamped byte path
#pragma unroll
    for (int m = 0; m < C; ++m)
      o[m] = byte_key_word(s, n_s, (long long)base + 4 * m);
  }
}

// A thread per pair: chunk after chunk of C key words of both suffixes
// until one differs or w symbols agree.  Adjacent pairs of a warp read in
// lock-step chunks so a shared suffix can be passed by shuffle.
template <int NW>
__global__ void __launch_bounds__(256)
suffix_lcp_pairs_kernel(const uint8_t* __restrict__ s, long long n_s,
                        const int32_t* __restrict__ pos_a,
                        const int32_t* __restrict__ pos_b, long long b,
                        int nw_rt, int32_t* __restrict__ out) {
  constexpr int C = NW == 1 ? 1 : NW == 2 ? 2 : 4;  // key words per chunk
  const int nw = NW ? NW : nw_rt;
  const int lane = threadIdx.x & 31;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is uniform across the warp: the shuffles see all lanes
  for (long long i0 = tid - lane; i0 < b; i0 += stride) {
    const long long i = i0 + lane;
    const bool valid = i < b;
    const int oa = valid ? __ldcs(pos_a + i) : 0;
    const int ob = valid ? __ldcs(pos_b + i) : 0;
    const int prev_b = __shfl_up_sync(FULL, ob, 1);
    const bool shared = valid && lane > 0 && oa == prev_b;
    int p = 4 * nw;
    bool done = !valid;
#pragma unroll 1
    for (int j0 = 0; j0 < nw; j0 += C) {
      const bool want = !done;
      if (!__any_sync(FULL, want)) break;
      // read pos_b's chunk also when the next pair takes it as its pos_a
      const bool next_takes = __shfl_down_sync(FULL, want && shared, 1) &&
                              lane < 31;
      uint32_t xa[C] = {}, xb[C] = {};
      if (want || next_takes) read_keys<C>(s, n_s, (uint32_t)ob, j0, xb);
      if (want && !shared) read_keys<C>(s, n_s, (uint32_t)oa, j0, xa);
#pragma unroll
      for (int m = 0; m < C; ++m) {
        const uint32_t from_prev = __shfl_up_sync(FULL, xb[m], 1);
        if (shared) xa[m] = from_prev;
      }
      if (want) {
#pragma unroll
        for (int m = C - 1; m >= 0; --m) {  // the first unequal word wins
          const uint32_t x = xa[m] ^ xb[m];
          if (x != 0 && j0 + m < nw) {
            p = 4 * (j0 + m) + (__clz(x) >> 3);
            done = true;
          }
        }
      }
    }
    if (valid) __stcs(out + i, p);
  }
}

template <int NW>
static cudaError_t launch(const uint8_t* s, long long n_s, const int32_t* a,
                          const int32_t* b_, long long b, int nw,
                          int32_t* out, cudaStream_t st) {
  const int threads = 256;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  suffix_lcp_pairs_kernel<NW><<<(unsigned)blocks, threads, 0, st>>>(
      s, n_s, a, b_, b, nw, out);
  return cudaGetLastError();
}

// w: a positive multiple of 4.  `s` must be 16-byte aligned.  Returns a
// cudaError_t code.
extern "C" int suffix_lcp_pairs(const void* s, long long n_s,
                                const void* pos_a, const void* pos_b,
                                long long b, int w, void* out,
                                void* stream) {
  if (b <= 0) return 0;
  if (w < 4 || w % 4 || n_s <= 0 || ((uintptr_t)s & 15u))
    return (int)cudaErrorInvalidValue;
  const uint8_t* sp = (const uint8_t*)s;
  const int32_t* a = (const int32_t*)pos_a;
  const int32_t* b_ = (const int32_t*)pos_b;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int nw = w / 4;
  switch (nw) {
    case 1: return (int)launch<1>(sp, n_s, a, b_, b, nw, o, st);
    case 2: return (int)launch<2>(sp, n_s, a, b_, b, nw, o, st);
    case 4: return (int)launch<4>(sp, n_s, a, b_, b, nw, o, st);
    case 8: return (int)launch<8>(sp, n_s, a, b_, b, nw, o, st);
    case 16: return (int)launch<16>(sp, n_s, a, b_, b, nw, o, st);
    case 32: return (int)launch<32>(sp, n_s, a, b_, b, nw, o, st);
    case 64: return (int)launch<64>(sp, n_s, a, b_, b, nw, o, st);
    default: return (int)launch<0>(sp, n_s, a, b_, b, nw, o, st);
  }
}
