// kmer_histogram: counts of the rolling base-`base` codes of every length-k
// window starting at 0..n-1 of a uint8 symbol string.
//
// Replaces the TPU kernel repro/kernels/kmer_histogram.py:kmer_histogram
// (pallas_call at :67), which keeps the whole histogram in VMEM and adds
// one-hot compares (the TPU has no scatter).  Here a grid-stride pass
// builds each window's code from k byte loads and adds it to a histogram
// in shared memory, which each block then adds into the global int32
// histogram with atomicAdd.  Lanes of a warp that hold the same code are
// merged first (__match_any_sync), so the few-bin histograms of small k
// do not serialise on one shared-memory address.
//
// Hazard: the TPU kernel allows 2^16 bins (256 KB), more than the 227 KB
// of shared memory a Hopper block can opt into.  When nbins * 4 bytes
// exceed the device's opt-in limit the kernel adds straight into the
// global histogram instead; both are kernel paths.  Integer sums are exact
// in any order, so atomics never change a count.
//
// Bound on the H100: memory.  The pass reads n + k - 1 bytes once (the
// k-byte windows overlap and hit L1/L2) and writes nbins * 4 bytes.
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ int window_code(const uint8_t* __restrict__ s,
                                           long long i, int k, int base) {
  int code = 0;
  for (int d = 0; d < k; ++d) code = code * base + (int)__ldg(s + i + d);
  return code;
}

__global__ void kmer_histogram_smem_kernel(const uint8_t* __restrict__ s,
                                           long long n, int k, int base,
                                           int nbins, int32_t* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // the loop bound is uniform across the block, so whole warps stay
  // converged for __match_any_sync
  for (long long base_i = (long long)blockIdx.x * blockDim.x; base_i < n;
       base_i += (long long)gridDim.x * blockDim.x) {
    long long i = base_i + threadIdx.x;
    bool valid = i < n;
    int code = valid ? window_code(s, i, k, base) : -1;
    unsigned peers = __match_any_sync(0xFFFFFFFFu, code);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&hist[code], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    int c = hist[b];
    if (c != 0) atomicAdd(out + b, c);
  }
}

__global__ void kmer_histogram_global_kernel(const uint8_t* __restrict__ s,
                                             long long n, int k, int base,
                                             int32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    atomicAdd(out + window_code(s, i, k, base), 1);
}

// Returns a cudaError_t; *used_smem reports which path ran (1: shared).
extern "C" int kmer_histogram(const void* s, long long n, int k, int base,
                              int nbins, void* out, int* used_smem,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)nbins * 4, st);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int threads = 256;
  size_t smem = (size_t)nbins * 4;
  if (smem <= (size_t)smem_optin) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kmer_histogram_smem_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    long long blocks = (n + threads - 1) / threads;
    long long cap = 2LL * sms;  // each block zeroes and flushes nbins bins
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    kmer_histogram_smem_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        (const uint8_t*)s, n, k, base, nbins, (int32_t*)out);
    *used_smem = 1;
  } else {
    long long blocks = (n + threads - 1) / threads;
    long long cap = 32LL * sms;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    kmer_histogram_global_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        (const uint8_t*)s, n, k, base, (int32_t*)out);
    *used_smem = 0;
  }
  return (int)cudaGetLastError();
}
