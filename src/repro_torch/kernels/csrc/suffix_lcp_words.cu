// suffix_lcp_words: per pair (pos_a, pos_b), the LCP in symbols of the two
// suffixes of the DENSE text, capped at w and at both terminal limits:
// min(first differing symbol, clip(n_real - pos_a, 0, w),
//     clip(n_real - pos_b, 0, w), w).
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:suffix_lcp_words
// (pallas_call at :453), whose _words_lcp_kernel DMAs two (2, tile)
// windows per pair, reads ceil(w/spw) substituted words of each suffix and
// finds the first differing word with an iota-min.  Here one thread per
// pair reads the substituted, shift-aligned words of both suffixes one at
// a time (dense_read.cuh's funnel shift), stops at the first nonzero XOR
// and takes __clz(x) / bits as the symbol within the word.
//
// Bound on the H100: memory.  A pair reads its two positions, writes one
// int32 and touches at most ceil(w/spw) + 1 text words per suffix, fewer
// when the suffixes differ early (the global LCP's boundary pairs and
// most node-build pairs differ within the first word or two).  The dense
// text of a 2^27-symbol DNA string (32 MiB) stays in the 50 MB L2.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void suffix_lcp_words_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos_a, const int32_t* __restrict__ pos_b,
    long long b, int nw, int w, int bits, long long n_real, uint32_t sub_word,
    int32_t* __restrict__ out) {
  const int spw = 32 / bits;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long oa = __ldg(pos_a + i);
    long long ob = __ldg(pos_b + i);
    long long p = (long long)nw * spw;  // equal rows
    for (int j = 0; j < nw; ++j) {
      uint32_t x = dense_read_word(words, n_words, oa, j, bits, spw, n_real,
                                   sub_word);
      uint32_t y = dense_read_word(words, n_words, ob, j, bits, spw, n_real,
                                   sub_word);
      if (x != y) {
        p = (long long)j * spw + __clz((int)(x ^ y)) / bits;
        break;
      }
    }
    long long la = n_real - oa;
    la = la < 0 ? 0 : (la > w ? w : la);
    long long lb = n_real - ob;
    lb = lb < 0 ? 0 : (lb > w ? w : lb);
    long long r = p < la ? p : la;
    r = r < lb ? r : lb;
    out[i] = (int32_t)(r < w ? r : w);
  }
}

extern "C" int suffix_lcp_words(const void* words, long long n_words,
                                const void* pos_a, const void* pos_b,
                                long long b, int nw, int w, int bits,
                                long long n_real, unsigned int sub_word,
                                void* out, void* stream) {
  const int threads = 256;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  suffix_lcp_words_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos_a,
      (const int32_t*)pos_b, b, nw, w, bits, n_real, (uint32_t)sub_word,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
