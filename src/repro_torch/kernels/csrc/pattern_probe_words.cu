// pattern_probe_words: -1/0/+1 per row, the masked dense pattern against
// the suffix at pos, by XOR, first differing word, clz and the
// terminal-limit rules of repro_torch.kernels.ref.probe_words_ref (the
// shared compare of probe_words.cuh).
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:pattern_probe_words
// (pallas_call at :383; rules of _words_probe_kernel, :306-331).  One
// thread per row walks the row's NW words and stops at the first nonzero
// XOR, so a row reads only as many text words as it needs.
//
// Bound on the H100: launch latency.  One search step of a batch of B
// patterns is 2B rows of a few words each, a few KB of traffic.  The
// searches of the main path no longer launch it once per step:
// search_bounds_words.cu runs the whole binary search in one launch with
// this compare.  This kernel stays the exact counterpart of the TPU
// function, and the single-step yardstick the search kernel is timed
// against.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_words.cuh"

__global__ void pattern_probe_words_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim_p, long long b, int nw, int bits,
    long long n_real, uint32_t sub_word, int32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    GlobalRow row{pat + i * nw, mask + i * nw};
    out[i] = probe_words_verdict<0>(words, n_words, pos[i], row, nw, bits,
                                    n_real, sub_word, lengths[i], lim_p[i]);
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
