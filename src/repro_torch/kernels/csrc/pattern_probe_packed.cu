// pattern_probe_packed: the byte-key probe of pattern_probe.cu reading
// the DENSE text: -1/0/+1 per row, bit-identical to the byte probe on the
// terminal-padded byte string.
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:pattern_probe_packed
// (pallas_call at :196), which DMAs a (2, tile) window of the staged
// words, expands every field to a byte, patches the virtual terminal,
// repacks and compares sign-flipped words.  Here one thread per row reads
// each shift-aligned dense word with dense_read.cuh's funnel shift,
// spreads each 4*bits-bit chunk to one byte key word (bit interleave),
// writes the terminal byte at every position >= n_real, masks, and stops
// at the first key word that differs (unsigned compare).
//
// Bound on the H100: launch latency, as pattern_probe_words: it serves
// the binary search of a batch carrying the terminal code, 2B rows of a
// few words per launch.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void pattern_probe_packed_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, long long b, int nw, int bits,
    long long n_real, uint32_t t_word, int32_t* __restrict__ out) {
  const int spw = 32 / bits;
  const int cpw = spw / 4;  // key words per dense word
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long p0 = pos[i];
    int v = 0;
    uint32_t aligned = 0u;
    for (int j = 0; j < nw; ++j) {
      if (j % cpw == 0)  // positions past n_real are patched, so sub = 0
        aligned = dense_read_word(words, n_words, p0, j / cpw, bits, spw,
                                  n_real, 0u);
      uint32_t key = dense_key_word(aligned, j, bits, p0, n_real, t_word);
      uint32_t sw = key & mask[i * nw + j];
      uint32_t pw = pat[i * nw + j];
      if (sw != pw) {
        v = sw < pw ? -1 : 1;
        break;
      }
    }
    out[i] = v;
  }
}

extern "C" int pattern_probe_packed(const void* words, long long n_words,
                                    const void* pos, const void* pat,
                                    const void* mask, long long b, int nw,
                                    int bits, long long n_real,
                                    unsigned int t_word, void* out,
                                    void* stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  pattern_probe_packed_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos,
      (const uint32_t*)pat, (const uint32_t*)mask, b, nw, bits, n_real,
      (uint32_t)t_word, (int32_t*)out);
  return (int)cudaGetLastError();
}
