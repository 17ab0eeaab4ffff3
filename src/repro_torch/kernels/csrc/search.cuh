// Shared code of the search kernels (search_bounds_words.cu,
// search_fetch_words.cu and the byte-key routes): the fixed-trip binary
// search of one row over the suffix array, the one-time read of its
// pattern row, and the whole byte-key search and find-and-fetch kernels
// with their launch, templated on a Text policy (probe_bytes.cuh
// ByteText: the byte string; probe_packed.cuh DenseText: the dense words).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "probe_words.cuh"

namespace search {

constexpr int kThreads = 64;     // a block: 512 rows spread over 8 SMs
constexpr int kMaxBlocks = 8192; // grid-stride beyond (~2x what is resident)

__device__ __forceinline__ long long clamp_row(long long x, long long total) {
  return x < 0 ? 0 : (x > total - 1 ? total - 1 : x);
}

// Lower bound (upper == false: the first suffix >= the pattern, a prefix
// match counting as >=) or upper bound (the first suffix > the pattern) of
// one row in [lo, hi), with at most n_iter trips, exactly as the loop
// repro_torch.kernels.search.search_loop runs them: mid = (lo + hi) / 2,
// the verdict at ell[clamp(mid, 0, total - 1)], then lo = mid + 1 or
// hi = mid.  The caller passes lo < hi and n_iter > 0; the row stops once
// lo >= hi, where the loop leaves it unchanged.
//
// Both candidate next midpoints are known before the verdict resolves:
// (mid + 1 + hi) / 2 if lo moves, (lo + mid) / 2 if hi does.  Their ell
// entries are loaded before the verdict's text reads, so the trip's two
// dependent reads (ell, then the text there) overlap with the next
// trip's ell read and a trip costs about one DRAM round trip.
template <class Verdict>
__device__ __forceinline__ long long search_row(
    const int32_t* __restrict__ ell, long long total, long long lo,
    long long hi, int n_iter, bool upper, const Verdict& verdict) {
  long long mid = (lo + hi) >> 1;  // lo, hi >= 0: the loop's floor division
  int32_t pos = __ldg(ell + clamp_row(mid, total));
  for (int t = 0; t < n_iter; ++t) {
    const long long mid_r = (mid + 1 + hi) >> 1;
    const long long mid_l = (lo + mid) >> 1;
    const int32_t pos_r = __ldg(ell + clamp_row(mid_r, total));
    const int32_t pos_l = __ldg(ell + clamp_row(mid_l, total));
    const int c = verdict(pos);
    if (upper ? c <= 0 : c < 0) {
      lo = mid + 1;
      mid = mid_r;
      pos = pos_r;
    } else {
      hi = mid;
      mid = mid_l;
      pos = pos_l;
    }
    if (lo >= hi) break;
  }
  return lo;
}

// Pattern row i (nw words) into registers, zero past nw.
template <int N>
__device__ __forceinline__ RegRow<N> load_row(
    const uint32_t* __restrict__ pat, const uint32_t* __restrict__ mask,
    long long i, int nw) {
  RegRow<N> row;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    row.pat[j] = j < nw ? __ldg(pat + i * nw + j) : 0u;
    row.mask[j] = j < nw ? __ldg(mask + i * nw + j) : 0u;
  }
  return row;
}

// Pattern row i into this thread's slots of the block's dynamic shared
// memory (2 * nw * blockDim.x words: the pattern words, then the mask
// words, word j of thread t at [j * blockDim.x + t]).  Each thread reads
// only its own slots, so no barrier is needed.
__device__ __forceinline__ SharedRow stage_row(
    uint32_t* stage, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, long long i, int nw) {
  const int stride = blockDim.x;
  uint32_t* sp = stage + threadIdx.x;
  uint32_t* sm = stage + (long long)nw * stride + threadIdx.x;
  for (int j = 0; j < nw; ++j) {
    sp[j * stride] = __ldg(pat + i * nw + j);
    sm[j * stride] = __ldg(mask + i * nw + j);
  }
  return SharedRow{sp, sm, stride};
}

// Launch shape of rows = B * bounds threads; the shared-memory route's
// bytes, opted in above the 48 KB default.
inline unsigned blocks_for(long long rows) {
  long long blocks = (rows + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

inline size_t stage_bytes(int nw) {
  return (size_t)2 * nw * kThreads * sizeof(uint32_t);
}

// ---- byte-key search and find-and-fetch over a Text policy ----
//
// A Text supplies
//   probe<NWR>(row, nw): a callable p0 -> -1/0/+1, the verdict of the
//     masked key words of the suffix at p0 against the pattern row
//     (NWR > 0: a register row of NWR words, nw <= NWR; 0: shared);
//   read_keys(p0, g0, g1, emit): emit(g, key word g of the suffix at p0)
//     for every g in [g0, g1).

template <class Text>
struct BoundsArgs {
  Text text;
  const int32_t* ell;
  long long total;
  const uint32_t* pat;
  const uint32_t* mask;
  const int32_t* lo0;
  const int32_t* hi0;
  long long b;
  int bounds, nw, n_iter;
  int32_t* out;
};

// Row r is pattern r mod B: rows < B give the lower bound (first suffix
// >= the pattern), rows >= B (bounds == 2) the upper bound (first suffix
// > it).  Rows with lo >= hi, or n_iter == 0, keep lo.
template <class Text, int NWR>
__global__ void __launch_bounds__(kThreads)
    bounds_kernel(const BoundsArgs<Text> a) {
  extern __shared__ uint32_t stage[];  // NWR == 0 only
  const long long rows = a.b * a.bounds;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += (long long)gridDim.x * blockDim.x) {
    const long long i = r < a.b ? r : r - a.b;
    long long lo = a.lo0[i];
    const long long hi = a.hi0[i];
    if (lo < hi && a.n_iter > 0) {
      if constexpr (NWR > 0) {
        const RegRow<NWR> row = load_row<NWR>(a.pat, a.mask, i, a.nw);
        lo = search_row(a.ell, a.total, lo, hi, a.n_iter, r >= a.b,
                        a.text.template probe<NWR>(row, a.nw));
      } else {
        const SharedRow row = stage_row(stage, a.pat, a.mask, i, a.nw);
        lo = search_row(a.ell, a.total, lo, hi, a.n_iter, r >= a.b,
                        a.text.template probe<0>(row, a.nw));
      }
    }
    a.out[r] = (int32_t)lo;
  }
}

template <class Text>
struct FetchArgs {
  Text text;
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

// Key words [g0, g1) of the read at p0 as four big-endian byte codes each,
// one 16-byte store per word (all -1, and no text read, when the pattern
// did not occur).
template <class Text>
__device__ __forceinline__ void store_keys(const Text& text, int32_t* row_out,
                                           int g0, int g1, long long p0,
                                           bool found) {
  if (!found) {
    for (int g = g0; g < g1; ++g)
      *reinterpret_cast<int4*>(row_out + 4 * g) = make_int4(-1, -1, -1, -1);
    return;
  }
  text.read_keys(p0, g0, g1, [&](int g, uint32_t w) {
    *reinterpret_cast<int4*>(row_out + 4 * g) =
        make_int4((int)(w >> 24), (int)((w >> 16) & 0xFFu),
                  (int)((w >> 8) & 0xFFu), (int)(w & 0xFFu));
  });
}

// Lane r of the grid-stride step: pattern i = r / 2, the upper bound when
// r is odd.  Every lane of the warp calls it (inactive ones too) for the
// shuffle.  The pattern's two bounds meet in its lane pair; both lanes
// read ell[clamp(llo)], the lower lane writes the verdict there and the
// first half of the window's key words, the upper lane the second half.
template <class Text, int NWR, class Row>
__device__ __forceinline__ void fetch_lane(const FetchArgs<Text>& a,
                                           const Row& row, bool active,
                                           long long i, bool upper) {
  const auto probe = a.text.template probe<NWR>(row, a.nw);
  long long lo = 0;
  if (active) {
    lo = a.lo0[i];
    const long long hi = a.hi0[i];
    if (lo < hi && a.n_iter > 0)
      lo = search_row(a.ell, a.total, lo, hi, a.n_iter, upper, probe);
  }
  const long long other = __shfl_xor_sync(0xffffffffu, lo, 1);
  if (!active) return;
  const long long llo = upper ? other : lo;
  const long long ulo = upper ? lo : other;
  const bool found = ulo > llo;
  const long long p0 = __ldg(a.ell + clamp_row(llo, a.total));
  const int groups = a.fetch / 4;
  const int half = (groups + 1) / 2;  // lower lane: key words [0, half)
  int32_t* row_out = a.window + i * a.fetch;
  if (upper) {
    store_keys(a.text, row_out, half, groups, p0, found);
    return;
  }
  a.verified[i] = probe(p0);
  store_keys(a.text, row_out, 0, half, p0, found);
  a.start[i] = (int32_t)llo;
  a.count[i] = found ? (int32_t)(ulo - llo) : 0;
}

// Lanes 2k and 2k + 1 take pattern k.  Every lane of a warp stays in the
// grid-stride loop until the shuffle (lanes past 2B are inactive but reach
// it), since lanes leave the search after different trip counts.
template <class Text, int NWR>
__global__ void __launch_bounds__(kThreads)
    fetch_kernel(const FetchArgs<Text> a) {
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
      const RegRow<NWR> row =
          active ? load_row<NWR>(a.pat, a.mask, i, a.nw) : RegRow<NWR>{};
      fetch_lane<Text, NWR>(a, row, active, i, r & 1);
    } else {
      const SharedRow row = active ? stage_row(stage, a.pat, a.mask, i, a.nw)
                                   : SharedRow{stage, stage, 0};
      fetch_lane<Text, 0>(a, row, active, i, r & 1);
    }
  }
}

// go(integral_constant<int, NWR>) for the template that holds nw pattern
// words: a register row of 2, 4, 8 or 16 words, else (0) shared memory.
template <class Go>
inline cudaError_t by_nw(int nw, Go&& go) {
  if (nw <= 2) return go(std::integral_constant<int, 2>{});
  if (nw <= 4) return go(std::integral_constant<int, 4>{});
  if (nw <= 8) return go(std::integral_constant<int, 8>{});
  if (nw <= 16) return go(std::integral_constant<int, 16>{});
  return go(std::integral_constant<int, 0>{});
}

// One launch of `kernel` over `threads` threads; the shared-memory route
// (NWR == 0) opts in to its bytes above the 48 KB default.
template <int NWR, class Args>
inline cudaError_t launch_rows(void (*kernel)(Args), long long threads,
                               const Args& a, int nw, cudaStream_t stream) {
  const size_t smem = NWR > 0 ? 0 : stage_bytes(nw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks_for(threads), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class Text>
inline cudaError_t launch_bounds(const BoundsArgs<Text>& a,
                                 cudaStream_t stream) {
  return by_nw(a.nw, [&](auto nwr) {
    constexpr int NWR = decltype(nwr)::value;
    return launch_rows<NWR>(bounds_kernel<Text, NWR>, a.b * a.bounds, a,
                            a.nw, stream);
  });
}

template <class Text>
inline cudaError_t launch_fetch(const FetchArgs<Text>& a,
                                cudaStream_t stream) {
  return by_nw(a.nw, [&](auto nwr) {
    constexpr int NWR = decltype(nwr)::value;
    return launch_rows<NWR>(fetch_kernel<Text, NWR>, 2 * a.b, a, a.nw,
                            stream);
  });
}

}  // namespace search
