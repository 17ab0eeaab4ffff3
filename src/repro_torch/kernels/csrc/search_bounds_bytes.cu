// search_bounds_bytes: the whole fixed-trip binary search of a batch of
// masked byte-key patterns over the suffix array of the terminal-padded
// uint8 string, in one launch.  Row r is pattern r mod B: rows < B give
// the lower bound (first suffix >= the pattern), rows >= B (bounds == 2)
// the upper bound (first suffix > it).
//
// Replaces the loop around the TPU kernel
// repro/kernels/pattern_probe.py:pattern_probe (:57): the fori_loop of
// repro/core/query.py:_search_bounds (:114-149) on the byte string
// (protein, english and byte text, and packing="bytes"), which launches
// the probe n_iter times per batch with ~14 small ops around each, and the
// lower-bound loop of repro/core/analytics.py:_matching_stats (:106-117,
// bounds == 1).  Each row runs that loop's trips exactly (search.cuh) with
// the compare of pattern_probe.cu (probe_bytes.cuh: masked keys compared
// unsigned, C5), so the result is bit-identical to the loop.
//
// Bound on the H100: dependent DRAM latency times trips, not bytes.  Each
// trip reads 4 B of ell and a key word or two of the text at a position
// only the previous trip knows; a batch moves a few KB.  What the design
// does about it: one launch per search instead of n_iter; the pattern row
// read once, into registers for NW <= 16 (a template on NW: serving rows
// of 4-24 symbols are 1-8 key words, the analytics window of 64 symbols
// 16) or into shared memory above (max_pattern_len 512 is 128 words); the
// next trip's two candidate ell entries loaded beside this trip's text
// read; a row stops as soon as its window is empty (routed protein
// windows hold hundreds of suffixes: ~10 trips, not n_iter); 64-thread
// blocks spread a batch over more SMs.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "probe_bytes.cuh"
#include "search.cuh"

template <int NWR>
__global__ void __launch_bounds__(search::kThreads) search_bounds_bytes_kernel(
    const uint8_t* __restrict__ s, long long n_s,
    const int32_t* __restrict__ ell, long long total,
    const uint32_t* __restrict__ pat, const uint32_t* __restrict__ mask,
    const int32_t* __restrict__ lo0, const int32_t* __restrict__ hi0,
    long long b, int bounds, int nw, int n_iter, int32_t* __restrict__ out) {
  extern __shared__ uint32_t stage[];  // NWR == 0 only
  const long long rows = b * bounds;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += (long long)gridDim.x * blockDim.x) {
    const long long i = r < b ? r : r - b;
    long long lo = lo0[i];
    const long long hi = hi0[i];
    if (lo < hi && n_iter > 0) {
      if constexpr (NWR > 0) {
        const RegRow<NWR> row = search::load_row<NWR>(pat, mask, i, nw);
        lo = search::search_row(ell, total, lo, hi, n_iter, r >= b,
                                [&](int32_t p0) {
          return probe_bytes_verdict<NWR>(s, n_s, p0, row, nw);
        });
      } else {
        const SharedRow row = search::stage_row(stage, pat, mask, i, nw);
        lo = search::search_row(ell, total, lo, hi, n_iter, r >= b,
                                [&](int32_t p0) {
          return probe_bytes_verdict<0>(s, n_s, p0, row, nw);
        });
      }
    }
    out[r] = (int32_t)lo;
  }
}

template <int NWR>
static cudaError_t launch(size_t smem, const uint8_t* s, long long n_s,
                          const int32_t* ell, long long total,
                          const uint32_t* pat, const uint32_t* mask,
                          const int32_t* lo0, const int32_t* hi0, long long b,
                          int bounds, int nw, int n_iter, int32_t* out,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        search_bounds_bytes_kernel<NWR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  search_bounds_bytes_kernel<NWR>
      <<<search::blocks_for(b * bounds), search::kThreads, smem, stream>>>(
          s, n_s, ell, total, pat, mask, lo0, hi0, b, bounds, nw, n_iter,
          out);
  return cudaGetLastError();
}

extern "C" int search_bounds_bytes(const void* s, long long n_s,
                                   const void* ell, long long total,
                                   const void* pat, const void* mask,
                                   const void* lo0, const void* hi0,
                                   long long b, int bounds, int nw,
                                   int n_iter, void* out, void* stream) {
  if (b * bounds == 0) return 0;
  auto go = [&](auto nwr, size_t smem) {
    return launch<decltype(nwr)::value>(
        smem, (const uint8_t*)s, n_s, (const int32_t*)ell, total,
        (const uint32_t*)pat, (const uint32_t*)mask, (const int32_t*)lo0,
        (const int32_t*)hi0, b, bounds, nw, n_iter, (int32_t*)out,
        (cudaStream_t)stream);
  };
  cudaError_t e;
  if (nw <= 2) e = go(std::integral_constant<int, 2>{}, 0);
  else if (nw <= 4) e = go(std::integral_constant<int, 4>{}, 0);
  else if (nw <= 8) e = go(std::integral_constant<int, 8>{}, 0);
  else if (nw <= 16) e = go(std::integral_constant<int, 16>{}, 0);
  else e = go(std::integral_constant<int, 0>{}, search::stage_bytes(nw));
  return (int)e;
}
