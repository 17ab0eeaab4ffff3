// flash_attention: causal (or full) online-softmax attention with GQA, the
// float32 route on the CUDA cores.  q (B, Sq, H, D), k/v (B, Sk, KV, D),
// all float32, contiguous; out (B, Sq, H, D) float32.  Query head h reads
// KV head h / (H / KV); the scale is 1/sqrt(D); with `causal`, row i sees
// keys j <= i, both counted from 0 (also for Sq != Sk).  Sums, the running
// max and the denominator are float32; out = acc / max(l, 1e-30), so a
// row with no visible key gives 0.  bfloat16 inputs run
// flash_attention_sm90.cu (wgmma tiles fed by TMA); the wrapper routes by
// dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body `_kernel` at :31, pallas_call at :94), which walks (blk_q, blk_k)
// blocks of one head on the TPU's sequential grid axis and keeps m, l and
// acc in VMEM scratch between grid steps.  Here one block owns BQ = 16
// query rows of one (b, h) and loops over the key tiles itself, up to
// the diagonal when causal (tiles above it are skipped, as `diag_ok`
// does); the ragged edge of Sq and Sk is masked, so any lengths >= 1 run.
//
// Design: each key tile (BK = 32 keys) of K and V is staged in shared
// memory as float32, rows padded to DP = 32 * ceil(D / 32) with zeros.
// One warp owns ROWS = 2 query rows; lane l holds q[d] and acc[d] for
// d = l, l + 32, ... (ceil(D / 32) values a row, so D = 256 keeps 16 of
// each in registers for the two rows).  For a tile, every lane forms its
// partial dot products with all 32 keys, and one transpose-reduction (31
// shuffles) leaves lane c with the full score of key c; the max, the
// correction and p then cost one value per lane, and p is broadcast key
// by key for acc += p * v.
//
// Bound on the H100: operations.  Attention in float32 has no tensor-core
// route as exact as the plain version's full-float32 products, so this
// kernel runs on the CUDA cores (67 TFLOP/s at best): it serves the
// float32 checks (the LM's float32 prefill, the parity cases), not the
// bf16 serving path.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 2;
constexpr int BQ = WARPS * ROWS;
constexpr int BK = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

// One step of the transpose-reduction over a warp: the lane keeps the
// half of its OFF-wide block of partial sums that its bit OFF selects and
// adds the partner's copy of that half.  OFF is a template argument so the
// loop fully unrolls and `part` stays in registers.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&part)[BK], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int c = 0; c < OFF; ++c) {
    const float send = up ? part[c] : part[c + OFF];
    const float keep = up ? part[c + OFF] : part[c];
    part[c] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq,
                           int sk, int h, int kvh, int d, int causal,
                           float scale) {
  constexpr int DP = DPL * 32;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + BK * DP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = head / (h / kvh);
  const int q0 = qt * BQ;
  const int row0 = q0 + warp * ROWS;

  float qr[ROWS][DPL], acc[ROWS][DPL], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = i * 32 + lane;
      qr[r][i] = (row < sq && dd < d)
                     ? load_f(q + ((b * sq + row) * h + head) * d + dd)
                     : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const int last = min(sq, q0 + BQ) - 1;  // the block's last row
  const int kend = causal ? min(sk, last + 1) : sk;
  for (int t0 = 0; t0 < kend; t0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DP; idx += WARPS * 32) {
      const int c = idx / DP;
      const int dd = idx - c * DP;
      const int j = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (j < sk && dd < d) {
        const long long off = ((b * sk + j) * kvh + kh) * d + dd;
        kx = load_f(k + off);
        vx = load_f(v + off);
      }
      ks[idx] = kx;
      vs[idx] = vx;
    }
    __syncthreads();
    if (row0 >= sq || (causal && t0 > row0 + ROWS - 1)) continue;

    // partial dot products of this lane's q slice with every key
    float part[ROWS][BK];
#pragma unroll
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part[r][c] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float kx = ks[c * DP + i * 32 + lane];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          part[r][c] = fmaf(qr[r][i], kx, part[r][c]);
      }
    }
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      // transpose-reduce: afterwards lane c holds the score of key t0 + c
      transpose_step<16>(part[r], lane);
      transpose_step<8>(part[r], lane);
      transpose_step<4>(part[r], lane);
      transpose_step<2>(part[r], lane);
      transpose_step<1>(part[r], lane);
      const int row = row0 + r;
      const int j = t0 + lane;
      const bool active = row < sq && (!causal || t0 <= row);  // warp-uniform
      const bool valid = active && j < sk && (!causal || j <= row);
      const float s = part[r][0] * scale;
      float mt = valid ? s : -INFINITY;
#pragma unroll
      for (int sh = 4; sh >= 0; --sh)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1 << sh));
      // an active row sees key t0 here, so mt is finite; an inactive row
      // keeps its state (corr 1, p 0)
      const float mn = active ? fmaxf(m[r], mt) : m[r];
      const float corr = active ? expf(m[r] - mn) : 1.f;
      p[r] = valid ? expf(s - mn) : 0.f;
      l[r] = l[r] * corr + p[r];
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
    }
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      float pc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pc[r] = __shfl_sync(FULL, p[r], c);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float vx = vs[c * DP + i * 32 + lane];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][i] = fmaf(pc[r], vx, acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    float lt = l[r];  // per-lane partial denominators share one max
#pragma unroll
    for (int sh = 4; sh >= 0; --sh) lt += __shfl_xor_sync(FULL, lt, 1 << sh);
    if (row >= sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = i * 32 + lane;
      if (dd < d) store_f(o + ((b * sq + row) * h + head) * d + dd,
                          acc[r][i] / denom);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kvh, int d, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = 2 * BK * DPL * 32 * sizeof(float);
  auto kern = flash_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, h, kvh, d, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kvh, int d, int causal, float scale,
             cudaStream_t s) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 5: return launch<T, 5>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 6: return launch<T, 6>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 7: return launch<T, 7>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    case 8: return launch<T, 8>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 tensors; shapes as in the header, d a multiple of 16 in
// [16, 256], h a multiple of kvh (the wrapper checks).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int sq, int sk, int h, int kvh,
                               int d, int causal, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 || d < 16 ||
      d > 256 || d % 16 != 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch<float>(q, k, v, o, b, sq, sk, h, kvh, d, causal, scale,
                         (cudaStream_t)stream);
}
