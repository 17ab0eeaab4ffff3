// probe_gather_words: find-and-fetch in one launch over the dense text.
// Per row, the -1/0/+1 verdict of pattern_probe_words.cu AND the
// ceil(fetch/spw) shift-aligned, terminal-substituted words that
// range_gather_words.cu returns at the same position.
//
// Replaces the TPU kernel repro/kernels/probe_gather.py:probe_gather_words
// (pallas_call at :132; body _fused_words_kernel, :47-76), which DMAs a
// (2, tile) window of the staged text rows per row and reads
// max(nw_pat, nw_out) dense words once for both halves.  Here one thread
// per row reads nw_rd = max(nw_pat, nw_out) words through dense_read.cuh's
// funnel shift, each word once: the first nw_out go to the window, the
// first nw_pat feed the verdict with the rules of pattern_probe_words.cu
// (masked XOR, first differing word, __clz / bits, both terminal limits
// saturated at the compare length, lim_p defaulting to the lengths).  The
// compare stops at its first difference; the read stops only once the
// window is written as well.
//
// Bound on the H100: launch latency at serving shapes.  A batch of B rows
// moves B * (nw_rd + 1) text words, 2 * B * nw_pat pattern and mask words,
// 3 * B positions, lengths and limits, and B * (nw_out + 1) output words:
// a few KB at B = 256 and fetch = 32, far below what one launch costs.  At
// large row counts the scattered text reads (L2 hits on the 32 MiB text
// of a 2^27-symbol DNA string) and the window stores bound it.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void probe_gather_words_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim_p, long long b, int nw_pat, int nw_out,
    int bits, long long n_real, uint32_t sub_word, int32_t* __restrict__ cmp,
    uint32_t* __restrict__ win) {
  const int spw = 32 / bits;
  const long long big = (long long)nw_pat * spw;
  const uint32_t ones = (1u << bits) - 1u;
  const int nw_rd = nw_pat > nw_out ? nw_pat : nw_out;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long p0 = pos[i];
    long long p = big;
    int sym = 0;
    uint32_t aw = 0, bw = 0;
    bool open = true;  // no differing word found yet
    for (int j = 0; j < nw_rd; ++j) {
      if (j >= nw_out && !open) break;  // window written, verdict decided
      uint32_t w = dense_read_word(words, n_words, p0, j, bits, spw, n_real,
                                   sub_word);
      if (j < nw_out) win[i * nw_out + j] = w;
      if (open && j < nw_pat) {
        uint32_t sw = w & mask[i * nw_pat + j];
        uint32_t pw = pat[i * nw_pat + j];
        uint32_t x = sw ^ pw;
        if (x != 0u) {
          sym = __clz((int)x) / bits;
          p = (long long)j * spw + sym;
          aw = sw;
          bw = pw;
          open = false;
        }
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
    cmp[i] = p < lim ? sym_sign : lim_sign;
  }
}

extern "C" int probe_gather_words(const void* words, long long n_words,
                                  const void* pos, const void* pat,
                                  const void* mask, const void* lengths,
                                  const void* lim_p, long long b, int nw_pat,
                                  int nw_out, int bits, long long n_real,
                                  unsigned int sub_word, void* cmp, void* win,
                                  void* stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  probe_gather_words_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos,
      (const uint32_t*)pat, (const uint32_t*)mask, (const int32_t*)lengths,
      (const int32_t*)lim_p, b, nw_pat, nw_out, bits, n_real,
      (uint32_t)sub_word, (int32_t*)cmp, (uint32_t*)win);
  return (int)cudaGetLastError();
}
