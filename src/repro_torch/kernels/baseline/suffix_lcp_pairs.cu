// The earlier design of csrc/suffix_lcp_pairs.cu, kept unchanged as the yardstick
// that chip_smoke.py and the --baseline benches time beside the current
// kernel (same results); the port never calls it.
//
// suffix_lcp_pairs: per pair (pos_a, pos_b), the index of the first
// unequal symbol of the two suffixes of a byte-per-symbol string within w
// symbols (w % 4 == 0), or w when they agree that far.  Every symbol index
// is clamped to n_s - 1, as gather_pack clamps.
//
// Replaces the TPU kernel repro/kernels/suffix_lcp.py:suffix_lcp_pairs
// (pallas_call at :80), which DMAs two (2, tile) windows of the staged
// string per pair and takes an iota-min over the w unequal symbols.  Here
// one thread per pair compares the suffixes four symbols at a time: each
// 4-symbol key word comes from two aligned 32-bit loads and one
// __byte_perm (byte_read.cuh, as in range_gather_pack), the thread stops
// at the first nonzero XOR and takes __clz(x) / 8 as the symbol within it.
//
// Bound on the H100: memory.  A pair reads its two positions, writes one
// int32 and touches two 8-byte windows of the text per compared word;
// the boundary pairs of the global LCP differ within a few symbols, and
// the node build's pairs within the first window unless they share a
// planted repeat.  The text (134 MB for 2^27 residues) is larger than the
// L2, so every window is a scattered device-memory sector.
#include <cuda_runtime.h>
#include <cstdint>

#include "byte_read.cuh"

__global__ void suffix_lcp_pairs_kernel(const uint8_t* __restrict__ s,
                                        long long n_s,
                                        const int32_t* __restrict__ pos_a,
                                        const int32_t* __restrict__ pos_b,
                                        long long b, int w,
                                        int32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long oa = __ldg(pos_a + i);
    long long ob = __ldg(pos_b + i);
    int first = w;
    for (int j = 0; 4 * j < w; ++j) {
      uint32_t x = byte_key_word(s, n_s, oa + 4LL * j);
      uint32_t y = byte_key_word(s, n_s, ob + 4LL * j);
      if (x != y) {
        first = 4 * j + (__clz((int)(x ^ y)) >> 3);
        break;
      }
    }
    out[i] = first;
  }
}

extern "C" int suffix_lcp_pairs(const void* s, long long n_s,
                                const void* pos_a, const void* pos_b,
                                long long b, int w, void* out,
                                void* stream) {
  const int threads = 256;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  suffix_lcp_pairs_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)s, n_s, (const int32_t*)pos_a, (const int32_t*)pos_b,
      b, w, (int32_t*)out);
  return (int)cudaGetLastError();
}
