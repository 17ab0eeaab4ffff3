// One dependent device-memory round trip, for measurement only: no path
// of the port launches it.
//
// The search kernels are bound by chains of dependent reads (an ell
// entry, then the text at the suffix it names), not by bytes, so their
// least time is the longest lane's chain times one round trip.  This
// kernel measures that round trip: a single thread follows `hops` links
// of a random cycle through a buffer far larger than the 50 MB L2, each
// load's address the value of the one before, with __ldcg (L2 only, no
// L1 allocation), so every hop is one round trip to device memory.  The
// walk resumes where the previous launch left it (*node), so repeated
// launches visit new lines and never find the walk's own lines in L2.
#include <cuda_runtime.h>

#include <cstdint>

__global__ void dram_latency_kernel(const uint32_t* __restrict__ next,
                                    long long hops,
                                    uint32_t* __restrict__ node) {
  uint32_t p = *node;
  for (long long h = 0; h < hops; ++h) p = __ldcg(next + p);
  *node = p;
}

extern "C" int dram_latency(const void* next, long long hops, void* node,
                            void* stream) {
  dram_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)next, hops, (uint32_t*)node);
  return (int)cudaGetLastError();
}
