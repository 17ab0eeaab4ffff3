// search_fetch_bytes: the whole find-and-fetch of a batch of masked
// byte-key patterns over the suffix array of the terminal-padded uint8
// string, in one launch.  Per pattern: the lower and upper bound search of
// search_bounds_bytes.cu, then at the first match ell[clamp(start)] the
// verdict of pattern_probe.cu and the fetch bytes range_gather_pack.cu
// reads there, written as int32 codes (-1 rows where nothing matched).
//
// Replaces the TPU composition repro/core/query.py:_find_fetch_batch
// (:207) on the byte string (protein, english and byte text, and
// packing="bytes"): the fori_loop of _search_bounds (:114-149) around
// repro/kernels/pattern_probe.py:pattern_probe (:57, pallas_call at :93),
// then at each lower bound pattern_probe again and
// repro/kernels/range_gather.py:range_gather_pack (:44), decoded by
// _window_symbols (:178).  It is bit-identical to that composition, which
// is what repro_torch.kernels.search.search_fetch_bytes runs on CPU
// tensors: start = llo, count = max(ulo - llo, 0), the verdict written for
// every row (count == 0 rows at the clamped position), the window bytes
// read with every index clamped to n_s - 1 as byte_read.cuh and the plain
// gather_pack clamp (C6, C12), codes unsigned (C5).
//
// Bound on the H100: dependent DRAM latency times trips, not bytes, as in
// search_fetch_words.cu, whose design this kernel shares: lanes 2k and
// 2k + 1 search pattern k's lower and upper bound (search.cuh), one
// __shfl_xor_sync pairs them, both read ell[clamp(llo)] once; the lower
// lane takes the verdict (probe_bytes.cuh) and the first half of the
// window's key words, the upper lane the second half, each key word
// (byte_read.cuh) split into four codes and written as one 16-byte store.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_bytes.cuh"
#include "search.cuh"

namespace fetch_bytes {

struct Args {
  const uint8_t* s;
  long long n_s;
  const int32_t* ell;
  long long total;
  const uint32_t* pat;
  const uint32_t* mask;
  const int32_t* lo0;
  const int32_t* hi0;
  long long b;
  int nw, n_iter, fetch;
  int32_t* start;
  int32_t* count;
  int32_t* window;  // (b, fetch), 16-byte aligned rows (fetch % 4 == 0)
  int32_t* verified;
};

// Key words [g0, g1) of the read at p0 as four big-endian byte codes each
// (all -1 when the pattern did not occur).
__device__ __forceinline__ void store_keys(const Args& a, int32_t* row_out,
                                           int g0, int g1, long long p0,
                                           bool found) {
  for (int g = g0; g < g1; ++g) {
    const uint32_t w = byte_key_word(a.s, a.n_s, p0 + 4LL * g);
    *reinterpret_cast<int4*>(row_out + 4 * g) = found
        ? make_int4((int)(w >> 24), (int)((w >> 16) & 0xFFu),
                    (int)((w >> 8) & 0xFFu), (int)(w & 0xFFu))
        : make_int4(-1, -1, -1, -1);
  }
}

// Lane r of the grid-stride step: pattern i = r / 2, the upper bound when
// r is odd.  Every lane of the warp calls it (inactive ones too) for the
// shuffle.
template <int NWR, class Row>
__device__ __forceinline__ void fetch_lane(const Args& a, const Row& row,
                                           bool active, long long i,
                                           bool upper) {
  long long lo = 0;
  if (active) {
    lo = a.lo0[i];
    const long long hi = a.hi0[i];
    if (lo < hi && a.n_iter > 0)
      lo = search::search_row(a.ell, a.total, lo, hi, a.n_iter, upper,
                              [&](int32_t p0) {
        return probe_bytes_verdict<NWR>(a.s, a.n_s, p0, row, a.nw);
      });
  }
  // the pattern's two bounds meet in its lane pair
  const long long other = __shfl_xor_sync(0xffffffffu, lo, 1);
  if (!active) return;
  const long long llo = upper ? other : lo;
  const long long ulo = upper ? lo : other;
  const bool found = ulo > llo;
  const long long p0 = __ldg(a.ell + search::clamp_row(llo, a.total));
  const int groups = a.fetch / 4;
  const int half = (groups + 1) / 2;  // lower lane: key words [0, half)
  int32_t* row_out = a.window + i * a.fetch;
  if (upper) {
    store_keys(a, row_out, half, groups, p0, found);
    return;
  }
  a.verified[i] = probe_bytes_verdict<NWR>(a.s, a.n_s, p0, row, a.nw);
  store_keys(a, row_out, 0, half, p0, found);
  a.start[i] = (int32_t)llo;
  a.count[i] = found ? (int32_t)(ulo - llo) : 0;
}

}  // namespace fetch_bytes

using fetch_bytes::Args;

template <int NWR>
__global__ void __launch_bounds__(search::kThreads)
    search_fetch_bytes_kernel(const Args a) {
  extern __shared__ uint32_t stage[];  // NWR == 0 only
  const long long rows = 2 * a.b;
  // blockDim.x is a multiple of 32, so a warp's lanes share `base` and
  // leave the loop together
  for (long long base = (long long)blockIdx.x * blockDim.x; base < rows;
       base += (long long)gridDim.x * blockDim.x) {
    const long long r = base + threadIdx.x;
    const bool active = r < rows;
    const long long i = r >> 1;
    if constexpr (NWR > 0) {
      const RegRow<NWR> row = active
          ? search::load_row<NWR>(a.pat, a.mask, i, a.nw) : RegRow<NWR>{};
      fetch_bytes::fetch_lane<NWR>(a, row, active, i, r & 1);
    } else {
      const SharedRow row = active
          ? search::stage_row(stage, a.pat, a.mask, i, a.nw)
          : SharedRow{stage, stage, 0};
      fetch_bytes::fetch_lane<0>(a, row, active, i, r & 1);
    }
  }
}

template <int NWR>
static cudaError_t launch(size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        search_fetch_bytes_kernel<NWR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  search_fetch_bytes_kernel<NWR>
      <<<search::blocks_for(2 * a.b), search::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

extern "C" int search_fetch_bytes(const void* s, long long n_s,
                                  const void* ell, long long total,
                                  const void* pat, const void* mask,
                                  const void* lo0, const void* hi0,
                                  long long b, int nw, int n_iter, int fetch,
                                  void* start, void* count, void* window,
                                  void* verified, void* stream) {
  if (b == 0) return 0;
  if (fetch <= 0 || fetch % 4 || nw <= 0 || total <= 0 || n_s <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)s, n_s, (const int32_t*)ell, total,
               (const uint32_t*)pat, (const uint32_t*)mask,
               (const int32_t*)lo0, (const int32_t*)hi0, b, nw, n_iter,
               fetch, (int32_t*)start, (int32_t*)count, (int32_t*)window,
               (int32_t*)verified};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (nw <= 2) e = launch<2>(0, a, st);
  else if (nw <= 4) e = launch<4>(0, a, st);
  else if (nw <= 8) e = launch<8>(0, a, st);
  else if (nw <= 16) e = launch<16>(0, a, st);
  else e = launch<0>(search::stage_bytes(nw), a, st);
  return (int)e;
}
