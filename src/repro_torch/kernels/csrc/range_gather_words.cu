// range_gather_words: per offset, ceil(w/spw) shift-aligned dense words
// of the text with the virtual terminal substituted past n_real.
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:range_gather_words
// (pallas_call at :295), which DMAs a (2, tile) window of staged text rows
// per offset.  Here every thread produces one (row, output word): it reads
// the two text words that straddle the read and funnel-shifts them, so the
// flat word array is read directly, with no tile staging.
//
// Bound on the H100: memory.  Per output word the kernel moves 4 B of
// output plus (shared across the row) 4 B of offset; the 2 text words it
// reads come mostly from L2, since the dense text of a 2^27-symbol DNA
// string is 32 MiB and fits the 50 MB L2.  Consecutive threads write
// consecutive output words (coalesced stores); reads of the text are
// scattered by design (offsets are suffix positions), which the L2
// residency of the text absorbs.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void range_gather_words_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ offs, long long total, int nw, int bits,
    long long n_real, uint32_t sub_word, uint32_t* __restrict__ out) {
  const int spw = 32 / bits;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    long long row = t / nw;
    int j = (int)(t - row * nw);
    long long off = __ldg(offs + row);
    out[t] = dense_read_word(words, n_words, off, j, bits, spw, n_real,
                             sub_word);
  }
}

extern "C" int range_gather_words(const void* words, long long n_words,
                                  const void* offs, long long f, int nw,
                                  int bits, long long n_real,
                                  unsigned int sub_word, void* out,
                                  void* stream) {
  long long total = f * nw;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  range_gather_words_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)offs, total, nw, bits,
      n_real, (uint32_t)sub_word, (uint32_t*)out);
  return (int)cudaGetLastError();
}
