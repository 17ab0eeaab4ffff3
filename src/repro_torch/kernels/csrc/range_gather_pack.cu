// range_gather_pack: per offset, the w symbols of a byte-per-symbol string
// packed big-endian four per 32-bit word (the byte sort keys of the
// elastic-range step), every symbol index clamped to n_s - 1.
//
// Replaces the TPU kernel repro/kernels/range_gather.py:range_gather_pack
// (pallas_call at :73), which DMAs a (2, tile) window of the staged string
// per offset and packs w symbols in VMEM.  Here every thread produces one
// (row, output word): two aligned 32-bit loads and a __byte_perm
// (byte_read.cuh), reading the flat string directly with no staging.
//
// Bound on the H100: memory.  Per output word the kernel writes 4 B and
// reads 4 B of offset (shared across the row) plus the 8 B around the
// symbols; offsets are suffix positions, so the reads are scattered and
// unaligned (each word costs two 4 B loads inside one or two 32 B
// sectors).  A 2^27-residue protein text is 134 MB, more than the 50 MB
// L2, so those sectors come from device memory.  Consecutive threads
// write consecutive output words (coalesced stores).
#include <cuda_runtime.h>
#include <cstdint>

#include "byte_read.cuh"

__global__ void range_gather_pack_kernel(const uint8_t* __restrict__ s,
                                         long long n_s,
                                         const int32_t* __restrict__ offs,
                                         long long total, int nw,
                                         uint32_t* __restrict__ out) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    long long row = t / nw;
    int j = (int)(t - row * nw);
    long long base = (long long)__ldg(offs + row) + 4LL * j;
    out[t] = byte_key_word(s, n_s, base);
  }
}

extern "C" int range_gather_pack(const void* s, long long n_s,
                                 const void* offs, long long f, int nw,
                                 void* out, void* stream) {
  long long total = f * nw;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  range_gather_pack_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)s, n_s, (const int32_t*)offs, total, nw,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
