// search_fetch_words: the whole find-and-fetch of a batch of masked dense
// patterns over the suffix array, in one launch.  Per pattern: the lower
// and upper bound search of search_bounds_words.cu, then at the first
// match ell[clamp(start)] the verdict and the fetched window of
// probe_gather_words.cu, the window decoded to int32 symbol codes (the
// terminal patched in past n_real, -1 rows where nothing matched).
//
// Replaces the TPU composition repro/core/query.py:_find_fetch_batch
// (:207) on the word path: the fori_loop of _search_bounds (:114-149)
// around repro/kernels/packed_gather.py:pattern_probe_words (:335), then
// the fused epilogue repro/kernels/probe_gather.py:probe_gather_words
// (:80, pallas_call at :132) at each lower bound and _window_symbols
// (:178).  It is bit-identical to that composition, which is what
// repro_torch.kernels.search.search_fetch_words runs on CPU tensors:
// start = llo, count = max(ulo - llo, 0), and the verdict written for
// every row (count == 0 rows at the clamped position, as the composition
// computes it).
//
// Bound on the H100: dependent DRAM latency times trips, not bytes.  A
// batch of 256 patterns moves a few KB; each search trip is a dependent
// ell read and a text read, and the epilogue adds one dependent ell read
// and one text read.  What the design does about it: the two bounds of
// pattern k run in lanes 2k (lower) and 2k + 1 (upper) of one warp, so
// after the search (search.cuh: both candidate ell entries prefetched per
// trip, the pattern row in registers for NW <= 16, interleaved shared
// memory above) one __shfl_xor_sync gives each lane the other's bound and
// the lower lane knows count without a second launch or a torch op.  Both
// lanes then read ell[clamp(llo)] once; the lower lane runs the
// compare-and-read of probe_gather_words.cuh (the verdict and the first
// half of the window's words, each text word read once), the upper lane
// reads the second half; each word is decoded in registers and written as
// 16-byte stores of four codes.  Every lane of a warp stays in the
// grid-stride loop until the shuffle (rows past 2B are inactive but reach
// it), since lanes leave the search after different trip counts.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_gather_words.cuh"
#include "search.cuh"

namespace fetch_words {

struct Args {
  const uint32_t* words;
  long long n_words;
  const int32_t* ell;
  long long total;
  const uint32_t* pat;
  const uint32_t* mask;
  const int32_t* lengths;
  const int32_t* lo0;
  const int32_t* hi0;
  long long b;
  int nw, n_iter, bits;
  long long n_real;
  uint32_t sub_word;
  int terminal, fetch;
  int32_t* start;
  int32_t* count;
  int32_t* window;  // (b, fetch), 16-byte aligned rows (fetch % 4 == 0)
  int32_t* verified;
};

// Window word j of a row (dense_read_word at p0), decoded: its bits-wide
// fields as int32 codes, the terminal at every position p0 + k >= n_real,
// all -1 when the pattern did not occur; four codes per 16-byte store.
__device__ __forceinline__ void store_codes(const Args& a, int32_t* row_out,
                                            int j, uint32_t w, long long p0,
                                            bool found) {
  const int spw = 32 / a.bits;
  const uint32_t ones = (1u << a.bits) - 1u;
  for (int g = j * spw; g < (j + 1) * spw && g < a.fetch; g += 4) {
    int c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = g + q - j * spw;  // the field inside word j
      int code = (int)((w >> (32 - a.bits * (k + 1))) & ones);
      if (p0 + g + q >= a.n_real) code = a.terminal;
      c[q] = found ? code : -1;
    }
    *reinterpret_cast<int4*>(row_out + g) = make_int4(c[0], c[1], c[2], c[3]);
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
  long long cmp_len = 0;
  if (active) {
    lo = a.lo0[i];
    const long long hi = a.hi0[i];
    cmp_len = a.lengths[i];
    if (lo < hi && a.n_iter > 0)
      lo = search::search_row(a.ell, a.total, lo, hi, a.n_iter, upper,
                              [&](int32_t p0) {
        return probe_words_verdict<NWR>(a.words, a.n_words, p0, row, a.nw,
                                        a.bits, a.n_real, a.sub_word, cmp_len,
                                        cmp_len);
      });
  }
  // the pattern's two bounds meet in its lane pair
  const long long other = __shfl_xor_sync(0xffffffffu, lo, 1);
  if (!active) return;
  const long long llo = upper ? other : lo;
  const long long ulo = upper ? lo : other;
  const bool found = ulo > llo;
  const long long p0 = __ldg(a.ell + search::clamp_row(llo, a.total));
  const int spw = 32 / a.bits;
  const int nw_out = (a.fetch + spw - 1) / spw;
  const int half = (nw_out + 1) / 2;  // lower lane: words [0, half)
  int32_t* row_out = a.window + i * a.fetch;
  auto emit = [&](int j, uint32_t w) {
    store_codes(a, row_out, j, w, p0, found);
  };
  if (upper) {
    for (int j = half; j < nw_out; ++j)
      emit(j, dense_read_word(a.words, a.n_words, p0, j, a.bits, spw,
                              a.n_real, a.sub_word));
    return;
  }
  a.verified[i] = probe_gather_words_row<NWR>(
      a.words, a.n_words, p0, row, a.nw, half, a.bits, a.n_real, a.sub_word,
      cmp_len, cmp_len, emit);
  a.start[i] = (int32_t)llo;
  a.count[i] = found ? (int32_t)(ulo - llo) : 0;
}

}  // namespace fetch_words

using fetch_words::Args;

template <int NWR>
__global__ void __launch_bounds__(search::kThreads)
    search_fetch_words_kernel(const Args a) {
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
      fetch_words::fetch_lane<NWR>(a, row, active, i, r & 1);
    } else {
      const SharedRow row = active
          ? search::stage_row(stage, a.pat, a.mask, i, a.nw)
          : SharedRow{stage, stage, 0};
      fetch_words::fetch_lane<0>(a, row, active, i, r & 1);
    }
  }
}

template <int NWR>
static cudaError_t launch(size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        search_fetch_words_kernel<NWR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  search_fetch_words_kernel<NWR>
      <<<search::blocks_for(2 * a.b), search::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

extern "C" int search_fetch_words(
    const void* words, long long n_words, const void* ell, long long total,
    const void* pat, const void* mask, const void* lengths, const void* lo0,
    const void* hi0, long long b, int nw, int n_iter, int bits,
    long long n_real, unsigned int sub_word, int terminal, int fetch,
    void* start, void* count, void* window, void* verified, void* stream) {
  if (b == 0) return 0;
  if ((bits != 2 && bits != 4 && bits != 8) || fetch <= 0 || fetch % 4 ||
      nw <= 0 || total <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint32_t*)words, n_words, (const int32_t*)ell, total,
               (const uint32_t*)pat, (const uint32_t*)mask,
               (const int32_t*)lengths, (const int32_t*)lo0,
               (const int32_t*)hi0, b, nw, n_iter, bits, n_real,
               (uint32_t)sub_word, terminal, fetch, (int32_t*)start,
               (int32_t*)count, (int32_t*)window, (int32_t*)verified};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (nw <= 2) e = launch<2>(0, a, s);
  else if (nw <= 4) e = launch<4>(0, a, s);
  else if (nw <= 8) e = launch<8>(0, a, s);
  else if (nw <= 16) e = launch<16>(0, a, s);
  else e = launch<0>(search::stage_bytes(nw), a, s);
  return (int)e;
}
