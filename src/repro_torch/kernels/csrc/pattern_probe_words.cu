// pattern_probe_words: -1/0/+1 per row, the masked dense pattern against
// the suffix at pos, by XOR, first differing word, clz and the
// terminal-limit rules of repro_torch.kernels.ref.probe_words_ref.
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:pattern_probe_words
// (pallas_call at :383; rules of _words_probe_kernel, :306-331).  One
// thread per row walks the row's NW words and stops at the first nonzero
// XOR, so a row reads only as many text words as it needs.
//
// Bound on the H100: launch latency.  A search batch of B patterns is 2B
// rows (lower and upper bound fused) of a few words each — a few KB of
// traffic — and the binary search launches the kernel n_iter times per
// batch (29 at n = 2^27), so the time per launch is the launch overhead,
// not bytes or operations.  Capturing the search loop in a CUDA graph is
// the remedy, left to a later change.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void pattern_probe_words_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim_p, long long b, int nw, int bits,
    long long n_real, uint32_t sub_word, int32_t* __restrict__ out) {
  const int spw = 32 / bits;
  const long long big = (long long)nw * spw;
  const uint32_t ones = (1u << bits) - 1u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long p0 = pos[i];
    long long p = big;
    int sym = 0;
    uint32_t aw = 0, bw = 0;
    for (int j = 0; j < nw; ++j) {
      uint32_t sw = dense_read_word(words, n_words, p0, j, bits, spw, n_real,
                                    sub_word) & mask[i * nw + j];
      uint32_t pw = pat[i * nw + j];
      uint32_t x = sw ^ pw;
      if (x != 0u) {
        sym = __clz((int)x) / bits;
        p = (long long)j * spw + sym;
        aw = sw;
        bw = pw;
        break;
      }
    }
    int sh = 32 - bits * (sym + 1);
    int ca = (int)((aw >> sh) & ones);
    int cb = (int)((bw >> sh) & ones);
    int sym_sign = ca < cb ? -1 : 1;
    // limits at or past the compare length saturate out of the comparison
    long long cmp_len = lengths[i];
    long long ls = n_real - p0;
    long long lp = lim_p[i];
    ls = ls < cmp_len ? ls : big;
    lp = lp < cmp_len ? lp : big;
    int lim_sign = ls < lp ? 1 : (lp < ls ? -1 : 0);
    long long lim = ls < lp ? ls : lp;
    out[i] = p < lim ? sym_sign : lim_sign;
  }
}

extern "C" int pattern_probe_words(const void* words, long long n_words,
                                   const void* pos, const void* pat,
                                   const void* mask, const void* lengths,
                                   const void* lim_p, long long b, int nw,
                                   int bits, long long n_real,
                                   unsigned int sub_word, void* out,
                                   void* stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  pattern_probe_words_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos,
      (const uint32_t*)pat, (const uint32_t*)mask, (const int32_t*)lengths,
      (const int32_t*)lim_p, b, nw, bits, n_real, (uint32_t)sub_word,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
