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
// saturated at the compare length by probe_words.cuh's resolve, lim_p
// defaulting to the lengths).  The
// compare stops at its first difference; the read stops only once the
// window is written as well.  That per-row body is probe_gather_words.cuh,
// shared with search_fetch_words.cu, which runs it after the search in the
// same launch on the find-and-fetch path; this kernel stays the exact
// counterpart of the TPU function and the yardstick the fused search is
// timed against.
//
// Bound on the H100: launch latency at serving shapes.  A batch of B rows
// moves B * (nw_rd + 1) text words, 2 * B * nw_pat pattern and mask words,
// 3 * B positions, lengths and limits, and B * (nw_out + 1) output words:
// a few KB at B = 256 and fetch = 32, far below what one launch costs.  At
// large row counts the scattered text reads (L2 hits on the 32 MiB text
// of a 2^27-symbol DNA string) and the window stores bound it.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_gather_words.cuh"

__global__ void probe_gather_words_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim_p, long long b, int nw_pat, int nw_out,
    int bits, long long n_real, uint32_t sub_word, int32_t* __restrict__ cmp,
    uint32_t* __restrict__ win) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t* out = win + i * nw_out;
    cmp[i] = probe_gather_words_row<0>(
        words, n_words, pos[i], GlobalRow{pat + i * nw_pat, mask + i * nw_pat},
        nw_pat, nw_out, bits, n_real, sub_word, lengths[i], lim_p[i],
        [&](int j, uint32_t w) { out[j] = w; });
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
