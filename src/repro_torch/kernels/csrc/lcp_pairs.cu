// lcp_pairs: per row of two (F, W) byte-key arrays, the index of the first
// differing byte (symbol) capped at w, and that byte of each row (c1, c2):
// the B = (c1, c2, offset) triplets of SubTreePrepare.  Fully equal rows
// give lcp = w and c1 = c2 = 0.
//
// Replaces the TPU kernel repro/kernels/lcp.py:lcp_pairs (pallas_call at
// :68), which expands each (blk, W) block to bytes and finds the first
// unequal byte with an iota-min reduction.  Here one thread per row walks
// the row's words and stops at the first nonzero XOR; the byte index is
// __clz(x) / 8, since keys are big-endian.
//
// Bound on the H100: memory.  At the elastic step's main shape (W = 1,
// one row per suffix) a thread reads 8 B and writes 12 B, all coalesced;
// for wide rows a thread reads only the words up to its first difference.
#include <cuda_runtime.h>
#include <cstdint>

__global__ void lcp_pairs_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b, long long f,
                                 int nw, int w, int32_t* __restrict__ lcp,
                                 int32_t* __restrict__ c1,
                                 int32_t* __restrict__ c2) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < f;
       i += (long long)gridDim.x * blockDim.x) {
    int first = nw * 4;
    int sh = 0;
    uint32_t aw = 0u, bw = 0u;
    for (int j = 0; j < nw; ++j) {
      uint32_t x = __ldg(a + i * nw + j);
      uint32_t y = __ldg(b + i * nw + j);
      if (x != y) {
        int byte = __clz((int)(x ^ y)) >> 3;
        first = j * 4 + byte;
        sh = 24 - 8 * byte;
        aw = x;
        bw = y;
        break;
      }
    }
    lcp[i] = first < w ? first : w;
    c1[i] = (int32_t)((aw >> sh) & 0xFFu);  // 0 when the rows are equal
    c2[i] = (int32_t)((bw >> sh) & 0xFFu);
  }
}

extern "C" int lcp_pairs(const void* a, const void* b, long long f, int nw,
                         int w, void* lcp, void* c1, void* c2,
                         void* stream) {
  const int threads = 256;
  long long blocks = (f + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  lcp_pairs_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, f, nw, w, (int32_t*)lcp,
      (int32_t*)c1, (int32_t*)c2);
  return (int)cudaGetLastError();
}
