// pattern_probe: -1/0/+1 per row, the masked byte keys of the suffix at
// pos against the packed pattern row, compared unsigned at the first
// differing word (0: the suffix starts with the pattern).
//
// Replaces the TPU kernel repro/kernels/pattern_probe.py:pattern_probe
// (pallas_call at :93), which DMAs a (2, tile) window per row, packs w
// symbols and compares sign-flipped words (signed order = unsigned
// order).  Here one thread per row builds each suffix word as
// range_gather_pack does (byte_read.cuh), ANDs it with the mask word and
// stops at the first word that differs; uint32_t compares are unsigned,
// which byte codes >= 128 need.  A zero mask word skips its load.
//
// Bound on the H100: launch latency.  A search step is 2B rows (lower and
// upper bound fused) of a few words each — a few KB — and the binary
// search launches the kernel n_iter times per batch.
#include <cuda_runtime.h>
#include <cstdint>

#include "byte_read.cuh"

__global__ void pattern_probe_kernel(const uint8_t* __restrict__ s,
                                     long long n_s,
                                     const int32_t* __restrict__ pos,
                                     const uint32_t* __restrict__ pat,
                                     const uint32_t* __restrict__ mask,
                                     long long b, int nw,
                                     int32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long p0 = pos[i];
    int v = 0;
    for (int j = 0; j < nw; ++j) {
      uint32_t m = mask[i * nw + j];
      uint32_t sw = m ? (byte_key_word(s, n_s, p0 + 4LL * j) & m) : 0u;
      uint32_t pw = pat[i * nw + j];
      if (sw != pw) {
        v = sw < pw ? -1 : 1;
        break;
      }
    }
    out[i] = v;
  }
}

extern "C" int pattern_probe(const void* s, long long n_s, const void* pos,
                             const void* pat, const void* mask, long long b,
                             int nw, void* out, void* stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  pattern_probe_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)s, n_s, (const int32_t*)pos, (const uint32_t*)pat,
      (const uint32_t*)mask, b, nw, (int32_t*)out);
  return (int)cudaGetLastError();
}
