// kmer_histogram: counts of the base-`base` codes of every length-k window
// starting at 0..n-1 of a uint8 symbol string.
//
// Replaces the TPU kernel repro/kernels/kmer_histogram.py:kmer_histogram
// (pallas_call at :67), which keeps the whole histogram in VMEM and adds
// one-hot compares (the TPU has no scatter).
//
// Bound on the H100: memory (n + k - 1 bytes read once, 0.04 ms at 2^27),
// but the add of each window's count sets the pace: every layout runs a
// 2^27 scan in about 0.15 ms whatever its bin count, the rate of one
// shared-memory atomic per window.  So the design reads each byte once,
// keeps every add in shared memory and keeps the SM full of threads:
//
// * Runs of windows, read once.  Each thread owns a run of RUN = 32
//   consecutive windows and loads the run's 32 + k - 1 bytes with three
//   aligned 16-byte loads; a warp covers 32 contiguous runs (1 KB), so its
//   loads coalesce.  The code rolls in registers as
//   code = (code * base + s[t]) mod base^k, exact in 32 bits while
//   base^k <= 2^16 (code * base + s[t] < 2^24); the modulo is a multiply-
//   high by a magic number with one correction.  No byte is loaded k times
//   and no index into the run is data-dependent, so the run stays in
//   registers.  The windows before the first 16-byte boundary of `s` (a
//   view may start anywhere) and the runs whose 48 bytes would pass byte
//   n + k - 1 use byte loads; no byte at or past n + k - 1 is read.
// * A histogram layout chosen by the bin count (the wrapper's plan,
//   repro_torch/kernels/kmer_histogram.plan):
//   - warp_copies: each warp adds into its own copy of the histogram, so
//     warps never contend.  Merging the lanes of a warp that hold the same
//     code first (__match_any_sync) measured 1.5-7.4x slower at every bin
//     count on the H100, even at 5 bins, so no layout merges: shared
//     atomics on a few addresses cost no more than on many;
//   - block: one histogram per block, blocks of 1024 threads as many per
//     SM as their shared memory allows (cudaOccupancy...), persistent;
//   - cluster: more bins than one block's shared memory (2^16 bins, 256 KB,
//     above the 227 KB a block can opt into): a thread-block cluster of 2
//     or 4 blocks, each holding a power-of-two share of the bins; a window
//     adds into the owning block's shared memory, its own directly and a
//     peer's through distributed shared memory.  cluster.sync() after
//     zeroing and before the flush keeps every block alive while a peer
//     can still write into it.
// * Flush: one global atomicAdd per nonzero bin per block (integer sums
//   are exact in any order).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

static constexpr int RUN = 32;      // windows a thread adds per run
static constexpr int SPAN = 48;     // bytes loaded per run: RUN + k - 1 <= 48
static constexpr int THREADS = 1024;

enum Layout { WARP_COPIES = 0, BLOCK = 1, CLUSTER = 2 };

// The 48 bytes at s[start..start+48) (16-byte aligned) as 12 little-endian
// words; bytes at or past `limit` read as 0 and are never loaded.
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ s,
                                         long long start, long long limit,
                                         uint32_t (&w)[12]) {
  if (start + SPAN <= limit) {
    const uint4* p = reinterpret_cast<const uint4*>(s + start);
    const uint4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = start + 4 * q + j;
      if (i < limit) v |= (uint32_t)__ldg(s + i) << (8 * j);
    }
    w[q] = v;
  }
}

struct Mod {  // x mod d for x < 2^24, d <= 2^16: one multiply-high
  uint32_t d, magic;
  __device__ __forceinline__ int operator()(uint32_t x) const {
    uint32_t r = x - __umulhi(x, magic) * d;  // quotient is exact or +1
    return (int)r < 0 ? (int)(r + d) : (int)r;
  }
};

template <int LAYOUT>
__device__ __forceinline__ void add(int* hist, int code, int share_log2,
                                    int rank) {
  if (LAYOUT == CLUSTER) {
    const int owner = code >> share_log2;
    const int bin = code & ((1 << share_log2) - 1);
    if (owner == rank) {
      atomicAdd(hist + bin, 1);
    } else {
      atomicAdd(cg::this_cluster().map_shared_rank(hist, owner) + bin, 1);
    }
  } else {
    atomicAdd(hist + code, 1);
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
kmer_histogram_kernel(const uint8_t* __restrict__ s, long long n, int k,
                      int base, int nbins, int head, int share_log2,
                      uint32_t magic, int32_t* __restrict__ out) {
  extern __shared__ int hist[];
  const int copies = LAYOUT == WARP_COPIES ? (int)(blockDim.x >> 5) : 1;
  const int local = LAYOUT == CLUSTER ? (1 << share_log2) : nbins;
  for (int b = threadIdx.x; b < copies * local; b += blockDim.x) hist[b] = 0;
  if (LAYOUT == CLUSTER) cg::this_cluster().sync(); else __syncthreads();

  int* mine = LAYOUT == WARP_COPIES ? hist + (threadIdx.x >> 5) * nbins : hist;
  const int rank =
      LAYOUT == CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const Mod mod{(uint32_t)nbins, magic};
  const int lane = threadIdx.x & 31;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long limit = n + k - 1;

  // windows before the first 16-byte boundary: k byte loads each
  if (tid < head) {
    int code = 0;
    for (int d = 0; d < k; ++d)
      code = mod((uint32_t)(code * base) + __ldg(s + tid + d));
    add<LAYOUT>(mine, code, share_log2, rank);
  }

  // runs of RUN windows from the aligned byte `head`, 32 contiguous runs
  // a warp
  const long long runs = n > head ? (n - head + RUN - 1) / RUN : 0;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r0 = (tid >> 5) * 32; r0 < runs; r0 += warps * 32) {
    const long long r = r0 + lane;
    const bool valid = r < runs;
    const long long start = head + r * RUN;
    uint32_t w[12];
    if (valid) {
      load_run(s, start, limit, w);
    } else {
#pragma unroll
      for (int q = 0; q < 12; ++q) w[q] = 0;
    }
    const long long left = n - start;  // windows of this run (>= 1 if valid)
    const int last = (int)(left < RUN ? left : RUN);
    int code = 0;
#pragma unroll
    for (int t = 0; t < SPAN; ++t) {
      code = mod((uint32_t)(code * base) +
                 ((w[t >> 2] >> (8 * (t & 3))) & 0xFFu));
      const int j = t - (k - 1);  // the window that ends at byte t
      if (valid && j >= 0 && j < last)
        add<LAYOUT>(mine, code, share_log2, rank);
    }
  }

  if (LAYOUT == CLUSTER) cg::this_cluster().sync(); else __syncthreads();
  const int first = rank << share_log2;
  for (int b = threadIdx.x; b < local && first + b < nbins; b += blockDim.x) {
    int c = 0;
    for (int q = 0; q < copies; ++q) c += hist[q * local + b];
    if (c != 0) atomicAdd(out + first + b, c);
  }
}

// The device's SM count and opt-in shared memory per block (the wrapper
// caches them per device).
extern "C" int kmer_histogram_device(int dev, int* sms, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                           dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// One launch on the layout the wrapper planned: `layout` 0 warp_copies,
// 1 block, 2 cluster (`cluster` blocks of 2^share_log2 bins each); `smem`
// bytes of shared memory per block of THREADS threads.  Returns a
// cudaError_t: a refused configuration (no block or cluster fits an SM) is
// an error.
extern "C" int kmer_histogram(const void* s, long long n, int k, int base,
                              int nbins, int layout, int smem, int cluster,
                              int share_log2, int sms, void* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)nbins * 4, st);
  if (err != cudaSuccess || n <= 0) return (int)err;
  if (k < 1 || k > SPAN - RUN + 1 || nbins < 2)
    return (int)cudaErrorInvalidValue;
  void (*fn)(const uint8_t*, long long, int, int, int, int, int, uint32_t,
             int32_t*);
  if (layout == WARP_COPIES)
    fn = kmer_histogram_kernel<WARP_COPIES>;
  else if (layout == BLOCK)
    fn = kmer_histogram_kernel<BLOCK>;
  else if (layout == CLUSTER)
    fn = kmer_histogram_kernel<CLUSTER>;
  else
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  const long long head_ll = (16 - (long long)((uintptr_t)s & 15)) & 15;
  const int head = (int)(head_ll < n ? head_ll : n);
  const long long runs = (n - head + RUN - 1) / RUN;
  long long blocks = (runs + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  // multiply-high magic of the modulo: floor(2^32 / nbins) + 1
  const uint32_t magic = (uint32_t)((1ULL << 32) / (unsigned)nbins + 1);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  if (layout == CLUSTER) {
    // as many clusters as fit on the card at once (the grid is persistent)
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3((unsigned)cluster);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = (blocks + cluster - 1) / cluster * cluster;
    if (blocks > (long long)clusters * cluster)
      blocks = (long long)clusters * cluster;
  }
  cfg.gridDim = dim3((unsigned)blocks);
  err = cudaLaunchKernelEx(&cfg, fn, (const uint8_t*)s, n, k, base, nbins,
                           head, share_log2, magic, (int32_t*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
