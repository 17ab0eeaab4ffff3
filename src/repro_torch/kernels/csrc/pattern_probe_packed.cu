// pattern_probe_packed: the byte-key probe of pattern_probe.cu reading
// the DENSE text: -1/0/+1 per row, bit-identical to the byte probe on the
// terminal-padded byte string.
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:pattern_probe_packed
// (pallas_call at :196), which DMAs a (2, tile) window of the staged
// words, expands every field to a byte, patches the virtual terminal,
// repacks and compares sign-flipped words.  Here one thread per row runs
// the compare of probe_packed.cuh: each shift-aligned dense word spread to
// byte key words (bit interleave), the terminal byte at every position
// >= n_real, the keys masked and compared unsigned up to the first that
// differs; a template on BITS.
//
// Bound on the H100: launch latency, as pattern_probe_words: one step of
// a binary search, 2B rows of a few words per launch.  The searches run
// every step of theirs in one launch (search_bounds_packed.cu,
// search_fetch_packed.cu); this kernel stays as the TPU kernel's
// counterpart and the single-step yardstick.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_packed.cuh"

template <int BITS>
__global__ void pattern_probe_packed_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, long long b, int nw, long long n_real,
    uint32_t t_word, int32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    const GlobalRow row{pat + i * nw, mask + i * nw};
    out[i] = packed::probe_packed_verdict<BITS, 0>(
        words, n_words, pos[i], row, nw, packed::live_words<0>(row, nw),
        n_real, t_word);
  }
}

template <int BITS>
static cudaError_t launch(const void* words, long long n_words,
                          const void* pos, const void* pat, const void* mask,
                          long long b, int nw, long long n_real,
                          uint32_t t_word, void* out, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  pattern_probe_packed_kernel<BITS><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos,
      (const uint32_t*)pat, (const uint32_t*)mask, b, nw, n_real, t_word,
      (int32_t*)out);
  return cudaGetLastError();
}

extern "C" int pattern_probe_packed(const void* words, long long n_words,
                                    const void* pos, const void* pat,
                                    const void* mask, long long b, int nw,
                                    int bits, long long n_real,
                                    unsigned int t_word, void* out,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (b == 0) return 0;
  if (bits == 2)
    return (int)launch<2>(words, n_words, pos, pat, mask, b, nw, n_real,
                          t_word, out, s);
  if (bits == 4)
    return (int)launch<4>(words, n_words, pos, pat, mask, b, nw, n_real,
                          t_word, out, s);
  if (bits == 8)
    return (int)launch<8>(words, n_words, pos, pat, mask, b, nw, n_real,
                          t_word, out, s);
  return (int)cudaErrorInvalidValue;
}
