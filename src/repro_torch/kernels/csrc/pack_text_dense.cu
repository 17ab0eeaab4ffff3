// pack_text_dense: the dense text store. The n_real uint8 symbol codes of a
// string packed big-endian at BITS bits a symbol into 32-bit words, the
// words of repro_torch/core/packing.PackedText; the words past the codes
// (the read tail and the halo word) are zero.
//
// Replaces no TPU kernel: the JAX package packs the text with numpy on the
// host (repro/core/packing.py:pack_text), and so did the port, at about
// 1.4 s a 2^27-symbol DNA string with the card idle, twice a build (the
// construction text and the served text).
//
// Bound on the H100: bytes, n_real read once and 4 * n_words written
// (160 MiB at 2^27 DNA symbols: 0.05 ms at 3.35 TB/s).  So the design
// reads each code once, in wide loads:
//
// * A thread makes one word from its SPW = 32 / BITS codes, read by one
//   aligned vector load (16 B for 2-bit, 8 B for 4-bit, 4 B for 8-bit); a
//   warp's loads are contiguous, its stores too.  The fields are squeezed
//   in registers: __byte_perm puts the first code of a 4-byte lane on top,
//   then two shift-and-mask steps pack the lane's four codes into 4 * BITS
//   bits.  The codes are read once, so the loads are streaming (__ldcs).
// * Codes at index >= n_real read as 0 and every word below n_words is
//   written, so the zero tail and the halo word need no memset.  The last
//   partial word (and every word of a view not aligned to SPW bytes) takes
//   byte loads, none at or past n_real.
// * A code >= 1 << BITS sets *bad: each thread ORs its codes, and a warp
//   with such a code makes one atomic (__any_sync).  The wrapper reads the
//   flag once and raises; the words are then left undefined.
// * 256 threads a block (no block size beat it for the port's text reads,
//   repro_torch/launch/block_sweep.py), a grid-stride loop over a grid of
//   eight blocks an SM.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

static constexpr int THREADS = 256;
static constexpr int BLOCKS_PER_SM = 2048 / THREADS;

// Four codes of a little-endian 4-byte lane, the first at the top, packed
// into the low 4 * BITS bits.  Exact for codes < 1 << BITS.
template <int BITS>
__device__ __forceinline__ uint32_t squeeze(uint32_t lane) {
  uint32_t v = __byte_perm(lane, 0, 0x0123);
  if (BITS == 4) {
    v = (v | (v >> 4)) & 0x00FF00FFu;
    v = (v | (v >> 8)) & 0x0000FFFFu;
  } else if (BITS == 2) {
    v = (v | (v >> 6)) & 0x000F000Fu;
    v = (v | (v >> 12)) & 0x000000FFu;
  }
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    pack_text_dense_kernel(const uint8_t* __restrict__ codes, long long n_real,
                           long long n_words, uint32_t* __restrict__ words,
                           int* __restrict__ bad) {
  constexpr int SPW = 32 / BITS;
  // the bits of a 4-byte lane that a valid code never sets
  constexpr uint32_t HIGH =
      BITS == 2 ? 0xFCFCFCFCu : (BITS == 4 ? 0xF0F0F0F0u : 0u);
  const long long n_full =
      reinterpret_cast<uintptr_t>(codes) % SPW == 0 ? n_real / SPW : 0;
  uint32_t seen = 0;  // every code this thread read, OR-ed
  for (long long w = blockIdx.x * (long long)THREADS + threadIdx.x;
       w < n_words; w += (long long)gridDim.x * THREADS) {
    uint32_t word = 0;
    const uint8_t* p = codes + w * SPW;
    if (w < n_full) {
      if constexpr (BITS == 2) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
        seen |= q.x | q.y | q.z | q.w;
        word = squeeze<2>(q.x) << 24 | squeeze<2>(q.y) << 16 |
               squeeze<2>(q.z) << 8 | squeeze<2>(q.w);
      } else if constexpr (BITS == 4) {
        const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
        seen |= q.x | q.y;
        word = squeeze<4>(q.x) << 16 | squeeze<4>(q.y);
      } else {
        const uint32_t q = __ldcs(reinterpret_cast<const unsigned int*>(p));
        seen |= q;
        word = squeeze<8>(q);
      }
    } else if (w * SPW < n_real) {
      const long long left = n_real - w * SPW;
      const int real = left < SPW ? (int)left : SPW;
      for (int k = 0; k < real; ++k) {
        const uint32_t c = p[k];
        seen |= c;
        word |= (c & ((1u << BITS) - 1)) << (32 - BITS * (k + 1));
      }
    }
    words[w] = word;
  }
  if (__any_sync(0xFFFFFFFFu, (seen & HIGH) != 0) && (threadIdx.x & 31) == 0)
    atomicOr(bad, 1);
}

// codes: uint8[n_real] on the device; words: uint32[n_words]; bad: one int,
// zero on entry, set to 1 when a code is >= 1 << bits.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for bits other than 2, 4 or 8).
extern "C" int pack_text_dense(const void* codes, long long n_real,
                               long long n_words, int bits, void* words,
                               void* bad, void* stream) {
  if (n_words <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n_words + THREADS - 1) / THREADS;
  const int grid = (int)std::min(need, (long long)sms * BLOCKS_PER_SM);
  auto s = (cudaStream_t)stream;
  auto in = (const uint8_t*)codes;
  auto out = (uint32_t*)words;
  auto flag = (int*)bad;
  switch (bits) {
    case 2:
      pack_text_dense_kernel<2><<<grid, THREADS, 0, s>>>(in, n_real, n_words,
                                                         out, flag);
      break;
    case 4:
      pack_text_dense_kernel<4><<<grid, THREADS, 0, s>>>(in, n_real, n_words,
                                                         out, flag);
      break;
    case 8:
      pack_text_dense_kernel<8><<<grid, THREADS, 0, s>>>(in, n_real, n_words,
                                                         out, flag);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
