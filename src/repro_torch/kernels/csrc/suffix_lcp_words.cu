// suffix_lcp_words: per pair (pos_a, pos_b), the LCP in symbols of the two
// suffixes of the DENSE text, capped at w and at both terminal limits:
// min(first differing symbol, clip(n_real - pos_a, 0, w),
//     clip(n_real - pos_b, 0, w), w).
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:suffix_lcp_words
// (pallas_call at :453), whose _words_lcp_kernel DMAs two (2, tile)
// windows per pair, reads ceil(w/spw) substituted words of each suffix and
// finds the first differing word with an iota-min.
//
// Bound on the H100: memory, and in practice the latency of scattered
// 32-byte L2 sectors.  A pair reads its two positions, writes one int32
// and touches the text words up to its first difference; the dense text
// of a 2^27-symbol DNA string (32 MiB) stays in the 50 MB L2.  The design:
//
// * Only the words that decide.  With L = min(both terminal limits, w),
//   the result is min(first difference, L), so a pair compares its first
//   ceil(L / spw) words and nothing else: no terminal substitution is
//   needed (every substituted symbol lies at or past L), and no word past
//   n_real is read for a suffix that reaches the end.
// * Chunked reads, early exit per chunk.  A thread per pair reads a
//   suffix's words in chunks of 4 shift-aligned words (fewer for NW < 4),
//   each from the two aligned 16-byte loads that cover its 5 text words,
//   and compares a chunk whole before it reads the next.  A pair that
//   differs in its first word reads no more sectors than a word-at-a-time
//   loop, and a long common prefix pays one dependent L2 round trip per 4
//   words, not per word.  (4 lanes per pair taking chunks in turn, with a
//   ballot for the first differing chunk, measured 1.6-3.0x slower than a
//   thread per pair from 64 symbols up on the H100, also with lane 0
//   alone reading the first chunk: a pair's 4 lanes multiply its
//   instructions, and most pairs differ in their first chunk.)
// * One read per shared suffix.  Adjacent leaves (the node build's pairs,
//   and consecutive pending pairs of later lcp_from_text rounds) share a
//   suffix: pos_a[i] == pos_b[i - 1].  Each lane reads its pos_b suffix;
//   one __shfl_up_sync of pos_b tells a lane that its pos_a suffix is its
//   neighbour's, and then it takes those words by shuffle, chunk by chunk,
//   instead of reading the text.  The exchange runs in lock-step chunks
//   while either lane still needs words: a lane whose own pair is decided
//   keeps reading its pos_b chunks while its neighbour needs them.  (The
//   alternative, each owner reading its suffix's whole span once, would
//   read up to w symbols for pairs that differ in their first word, the
//   common case.)  Lane 0 of a warp, a lane whose neighbour differs, and
//   the analytics' boundary pairs read their pos_a suffix themselves.
// * Templates on BITS (2, 4, 8: divisions become shifts) and on the NW
//   bucket (1, 2, 4, 8, 16, 32, 64; any other width takes the runtime-nw
//   instantiation); 32-bit arithmetic for positions
//   and word indices.  Positions stream in through __ldcs and results
//   out through __stcs, so a 2^27-pair round does not evict the text from
//   L2.
#include <cuda_runtime.h>

#include <cstdint>

// The threads a block.  launch/block_sweep.py builds this source at
// other blocks (-DERA_BLOCK_THREADS) to time them; the port builds 256.
#ifndef ERA_BLOCK_THREADS
#define ERA_BLOCK_THREADS 256
#endif

static constexpr unsigned FULL = 0xFFFFFFFFu;

// Output words j0 .. j0 + C - 1 of the suffix whose first symbol lies in
// text word `tw` at bit shift `sh`: the funnel shift of text words
// tw + j0 .. tw + j0 + C.  With C = 4 and an aligned text these come from
// the two aligned 16-byte loads covering them; indices past the array
// are clamped to its last word (those symbols lie past the limit).
template <int C>
__device__ __forceinline__ void read_chunk(const uint32_t* __restrict__ words,
                                           long long n_words, bool vec,
                                           uint32_t tw, int sh, int j0,
                                           uint32_t (&o)[C]) {
  const uint32_t base = tw + (uint32_t)j0;
  uint32_t t[C + 1];
  const uint32_t g0 = base & ~3u;
  if (C == 4 && vec && (long long)g0 + 8 <= n_words) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(words + g0));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(words + g0 + 4));
    const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    const int d = (int)(base & 3u);
#pragma unroll
    for (int m = 0; m <= C; ++m)
      t[m] = d == 0 ? v[m] : d == 1 ? v[m + 1] : d == 2 ? v[m + 2] : v[m + 3];
  } else {
#pragma unroll
    for (int m = 0; m <= C; ++m) {
      const long long i = (long long)base + m;
      t[m] = __ldg(words + (i < n_words - 1 ? i : n_words - 1));
    }
  }
#pragma unroll
  for (int m = 0; m < C; ++m) o[m] = __funnelshift_l(t[m + 1], t[m], sh);
}

// A thread per pair: chunk after chunk of C words of both suffixes until
// one differs or the pair's limit is reached.  Adjacent pairs of a warp
// read in lock-step chunks so a shared suffix can be passed by shuffle.
template <int BITS, int NW>
__global__ void __launch_bounds__(ERA_BLOCK_THREADS)
suffix_lcp_words_kernel(const uint32_t* __restrict__ words, long long n_words,
                        const int32_t* __restrict__ pos_a,
                        const int32_t* __restrict__ pos_b, long long b,
                        int nw_rt, int w, long long n_real, int vec,
                        int32_t* __restrict__ out) {
  constexpr int SPW = 32 / BITS;
  constexpr int LOG_SPW = BITS == 2 ? 4 : BITS == 4 ? 3 : 2;
  constexpr int C = NW == 1 ? 1 : NW == 2 ? 2 : 4;  // words per chunk
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
    long long la = n_real - oa, lb = n_real - ob;
    la = la < 0 ? 0 : (la > w ? w : la);
    lb = lb < 0 ? 0 : (lb > w ? w : lb);
    const int lim = valid ? (int)(la < lb ? la : lb) : 0;
    const int need = (lim + SPW - 1) >> LOG_SPW;  // words that decide
    const uint32_t twa = (uint32_t)oa >> LOG_SPW;
    const uint32_t twb = (uint32_t)ob >> LOG_SPW;
    const int sha = BITS * (oa & (SPW - 1));
    const int shb = BITS * (ob & (SPW - 1));
    int p = lim;
    bool done = false;
#pragma unroll 1
    for (int j0 = 0; j0 < nw; j0 += C) {
      const bool want = !done && j0 < need;
      if (!__any_sync(FULL, want)) break;
      // read pos_b's chunk also when the next pair takes it as its pos_a
      const bool next_takes = __shfl_down_sync(FULL, want && shared, 1) &&
                              lane < 31;
      uint32_t xa[C] = {}, xb[C] = {};
      if (want || next_takes)
        read_chunk<C>(words, n_words, vec, twb, shb, j0, xb);
      if (want && !shared)
        read_chunk<C>(words, n_words, vec, twa, sha, j0, xa);
#pragma unroll
      for (int m = 0; m < C; ++m) {
        const uint32_t from_prev = __shfl_up_sync(FULL, xb[m], 1);
        if (shared) xa[m] = from_prev;
      }
      if (want) {
#pragma unroll
        for (int m = C - 1; m >= 0; --m) {  // the first differing word wins
          const uint32_t x = xa[m] ^ xb[m];
          if (x != 0 && j0 + m < need) {
            const int d = (j0 + m) * SPW + __clz(x) / BITS;
            p = d < lim ? d : lim;
            done = true;
          }
        }
      }
    }
    if (valid) __stcs(out + i, p);
  }
}

struct Args {
  const void* words;
  long long n_words;
  const void* pos_a;
  const void* pos_b;
  long long b;
  int nw, w;
  long long n_real;
  void* out;
  cudaStream_t st;
};

template <int BITS, int NW>
cudaError_t launch(const Args& a) {
  const int threads = ERA_BLOCK_THREADS;
  long long blocks = (a.b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  const int vec = ((uintptr_t)a.words & 15) == 0;
  suffix_lcp_words_kernel<BITS, NW><<<(unsigned)blocks, threads, 0, a.st>>>(
      (const uint32_t*)a.words, a.n_words, (const int32_t*)a.pos_a,
      (const int32_t*)a.pos_b, a.b, a.nw, a.w, a.n_real, vec,
      (int32_t*)a.out);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t dispatch(const Args& a) {
  switch (a.nw) {
    case 1: return launch<BITS, 1>(a);
    case 2: return launch<BITS, 2>(a);
    case 4: return launch<BITS, 4>(a);
    case 8: return launch<BITS, 8>(a);
    case 16: return launch<BITS, 16>(a);
    case 32: return launch<BITS, 32>(a);
    case 64: return launch<BITS, 64>(a);
    default: return launch<BITS, 0>(a);
  }
}

extern "C" int suffix_lcp_words(const void* words, long long n_words,
                                const void* pos_a, const void* pos_b,
                                long long b, int nw, int w, int bits,
                                long long n_real, void* out, void* stream) {
  if (nw < 1 || w < 1 || w > nw * (32 / bits))
    return (int)cudaErrorInvalidValue;
  const Args a{words, n_words, pos_a, pos_b, b, nw, w, n_real, out,
               (cudaStream_t)stream};
  switch (bits) {
    case 2: return (int)dispatch<2>(a);
    case 4: return (int)dispatch<4>(a);
    case 8: return (int)dispatch<8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
