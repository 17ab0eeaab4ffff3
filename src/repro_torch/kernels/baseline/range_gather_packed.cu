// The earlier design of csrc/range_gather_packed.cu, kept unchanged as the yardstick
// that chip_smoke.py and the --baseline benches time beside the current
// kernel (same results); the port never calls it.
//
// range_gather_packed: per offset, the w symbols of the DENSE text as
// big-endian byte keys, four symbols per 32-bit word, with the terminal
// byte past n_real -- bit-identical to range_gather_pack on the
// terminal-padded byte string.
//
// Replaces the TPU kernel repro/kernels/packed_gather.py:range_gather_packed
// (pallas_call at :129), which DMAs a (2, tile) window of the staged words
// per offset, expands every field to one symbol, patches the virtual
// terminal and repacks bytes in VMEM.  Here every thread produces one
// (row, key word): it reads the shift-aligned dense word that holds the
// key word's symbols (dense_read.cuh's funnel shift of two text words)
// and spreads its 4*bits-bit chunk to bytes (dense_key_word), so the flat
// word array is read directly with no staging and no per-symbol loop.
//
// Bound on the H100: memory.  Per output word the kernel writes 4 B and
// reads 4 B of offset (shared across the row) plus two text words; the
// dense text of a 2^27-symbol DNA string is 32 MiB and stays in the 50 MB
// L2, so the scattered text reads (offsets are suffix positions) are L2
// hits.  Consecutive threads write consecutive output words.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void range_gather_packed_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ offs, long long total, int nw, int bits,
    long long n_real, uint32_t t_word, uint32_t* __restrict__ out) {
  const int spw = 32 / bits;
  const int cpw = spw / 4;  // key words per dense word
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    long long row = t / nw;
    int j = (int)(t - row * nw);
    long long off = __ldg(offs + row);
    // positions past n_real are patched by dense_key_word, so sub = 0
    uint32_t aligned =
        dense_read_word(words, n_words, off, j / cpw, bits, spw, n_real, 0u);
    out[t] = dense_key_word(aligned, j, bits, off, n_real, t_word);
  }
}

extern "C" int range_gather_packed(const void* words, long long n_words,
                                   const void* offs, long long f, int nw,
                                   int bits, long long n_real,
                                   unsigned int t_word, void* out,
                                   void* stream) {
  long long total = f * nw;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  range_gather_packed_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)offs, total, nw, bits,
      n_real, (uint32_t)t_word, (uint32_t*)out);
  return (int)cudaGetLastError();
}
