// flash_attention_sm90: causal (or full) online-softmax attention with GQA
// for bfloat16, on Hopper's tensor cores (wgmma tiles fed by TMA).
// q (B, Sq, H, D), k/v (B, Sk, KV, D), all bfloat16, contiguous, 16-byte
// aligned; out (B, Sq, H, D) bfloat16.  Query head h reads KV head
// h / (H / KV); the scale is 1/sqrt(D) (passed as scale * log2(e)); with
// `causal`, row i sees keys j <= i, both counted from 0 (also for
// Sq != Sk).  The running max, the denominator and the accumulator are
// float32; out = acc / max(l, 1e-30).  float32 inputs run
// flash_attention.cu (CUDA cores) instead; the wrapper routes by dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body `_kernel` at :31, pallas_call at :94).
//
// Bound on the H100: operations.  At the prefill shape of qwen3-1.7b
// (B 4, S 2048, H 16, KV 8, D 128, causal) one call is 68.7 GFLOP of
// QK^T and PV against < 0.1 GB of inputs and output: 0.07 ms at the
// 989 TFLOP/s bf16 tensor-core peak.  The design goes to the tensor cores:
//
// * One block holds 128 query rows in two consumer warpgroups of 64 rows:
//   the two query heads of a GQA group on the same rows when H / KV is
//   even, else two consecutive 64-row tiles of one head.  Each K/V tile
//   the block loads serves all 128 rows.
// * One producer warp loads Q once and K/V tiles of 64 keys into a ring
//   of STAGES slots with TMA (cp.async.bulk.tensor over the 4-D
//   (B, S, heads, D) layouts, 64 x 64 boxes with the 128-byte swizzle;
//   out-of-bounds rows and head columns read as zeros), completing on
//   mbarriers; the consumers release a slot through an `empty` mbarrier.
// * S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//   (K-major), float32 accumulation; the online softmax runs on the
//   accumulator fragment (exp2 with the scale folded in), masking the
//   ragged edges of Sq, Sk and the causal diagonal per key.
// * O += P V is wgmma m64n64k16 per 64 columns of D with P from registers
//   (the accumulator fragment of S is the A fragment of the product) and
//   V read in its row-major (key, D) layout through the B transpose.
//   P is split as hi = bf16(P), lo = bf16(P - hi), and both products add
//   into the same float32 accumulator: ~16 bits of P, where a single bf16
//   P would give each term an error of 2^-9 and break the parity bound.
// * Causal tiles run longest rows first (the 1-D grid's slowest index is
//   the reversed query tile); each warpgroup skips key tiles past its own
//   last row but still releases them.
// * D up to 256 is DC = ceil(D / 64) column chunks of 64; chunks past D
//   are zero-filled by TMA and add nothing, and are not stored.
//
// A wait that never completes (a fault in this file's barrier protocol)
// traps after ~2^26 polls instead of hanging the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 64;          // query rows per consumer warpgroup
constexpr int BK = 64;          // keys per tile
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int TILE = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 box
constexpr uint32_t SPIN_LIMIT = 1u << 26;
constexpr unsigned FULL = 0xffffffffu;

template <int DC>
struct Smem {  // byte offsets from a 1024-aligned base
  static constexpr int STAGES = DC <= 3 ? 3 : 2;
  static constexpr int Q = 0;                       // [CONSUMERS][DC]
  static constexpr int K = Q + CONSUMERS * DC * TILE;  // [STAGES][DC]
  static constexpr int V = K + STAGES * DC * TILE;     // [STAGES][DC]
  static constexpr int BAR = V + STAGES * DC * TILE;   // q, full[], empty[]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == SPIN_LIMIT) __trap();
  }
}

// One 64 x 64 box of a 4-D (D, heads, S, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define OUT32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, A (64 x 16) and B (16 x 64) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OUT32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16) from registers, B (16 x 64) from shared memory
// stored MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

// Keys a warpgroup's rows [q0, q0 + BM) need: 0 when the tile lies past Sq.
__device__ __forceinline__ int rows_keys(int q0, int sq, int sk, int causal) {
  if (q0 >= sq) return 0;
  return causal ? min(sk, min(sq, q0 + BM)) : sk;
}

template <int DC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, int nb, int sq,
                                int sk, int h, int kvh, int d, int causal,
                                float sl2, int n_qt, int n_hg) {
  using L = Smem<DC>;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::BAR;
  const uint32_t full_bar = q_bar + 8;             // [ST]
  const uint32_t empty_bar = q_bar + 8 + 8 * ST;   // [ST]

  // block -> (query tile, head group, batch), the longest causal rows first
  const int hg = blockIdx.x % n_hg;
  const int rest = blockIdx.x / n_hg;
  const int bb = rest % nb;
  const int qt = n_qt - 1 - rest / nb;
  const int g = h / kvh;
  const bool pair = (g % 2) == 0;
  // warpgroup w's head and first row
  auto head_of = [&](int w) { return pair ? CONSUMERS * hg + w : hg; };
  auto q0_of = [&](int w) {
    return pair ? qt * BM : (qt * CONSUMERS + w) * BM;
  };
  const int keys0 = rows_keys(q0_of(0), sq, sk, causal);
  const int keys1 = rows_keys(q0_of(1), sq, sk, causal);
  const int kh = head_of(0) / g;
  const int ntiles = (max(keys0, keys1) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS * 4);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == CONSUMERS * 4) {  // the producer warp
    if (lane != 0) return;
    uint32_t q_bytes = 0;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w)
      if (q0_of(w) < sq) q_bytes += DC * TILE;
    mbar_expect_tx(q_bar, q_bytes);
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) {
      if (q0_of(w) >= sq) continue;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(base + L::Q + (w * DC + c) * TILE, &tq, q_bar, 64 * c,
                 head_of(w), q0_of(w), bb);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % ST;
      mbar_wait(empty_bar + 8 * s, ((t / ST) & 1) ^ 1);
      mbar_expect_tx(full_bar + 8 * s, 2 * DC * TILE);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tma_load(base + L::K + (s * DC + c) * TILE, &tk, full_bar + 8 * s,
                 64 * c, kh, t * BK, bb);
        tma_load(base + L::V + (s * DC + c) * TILE, &tv, full_bar + 8 * s,
                 64 * c, kh, t * BK, bb);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 rows of one head ----
  const int w = warp >> 2;
  const int r0 = q0_of(w) + (warp & 3) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);  // the fragment's first column in 8
  const int my_keys = w ? keys1 : keys0;
  const uint32_t qs = base + L::Q + w * DC * TILE;
  float acc[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % ST;
    mbar_wait(full_bar + 8 * s, (t / ST) & 1);
    if (t * BK < my_keys) {  // warpgroup-uniform
      const uint32_t ks = base + L::K + s * DC * TILE;
      const uint32_t vs = base + L::V + s * DC * TILE;
      // S = Q K^T over D in steps of 16 (32 bytes inside a swizzled row)
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk) {
        const uint32_t off = (kk >> 2) * TILE + (kk & 3) * 32;
        wgmma_ss(sc, sw128_desc(qs + off, 16, 1024),
                 sw128_desc(ks + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(sc);

      // online softmax on the fragment: element i is row (i & 2 ? r1 : r0),
      // key t * BK + 8 * (i / 4) + cq + (i & 1)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t * BK + 8 * (i >> 2) + cq + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        const bool ok = key < sk && (!causal || key <= row);
        sc[i] = ok ? sc[i] : -INFINITY;
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * sl2;
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * sl2;
      const float c0 = exp2f(m0 * sl2 - ms0), c1 = exp2f(m1 * sl2 - ms1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(fmaf(sc[i], sl2, (i & 2) ? -ms1 : -ms0));
        sc[i] = p;
        if (i & 2) ps1 += p;
        else ps0 += p;
      }
      l0 = l0 * c0 + ps0;  // per-lane partial sums under one max
      l1 = l1 * c1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= (i & 2) ? c1 : c0;

      // P as A fragments, hi and lo halves: k-step kk covers keys
      // 16 kk .. 16 kk + 15, register r the pair sc[8 kk + 2 r], +1
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = bf16x2_bits(hi);
          pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
        }

      // O += P V: V's 16 keys of step kk start 16 rows (2048 bytes) in
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const uint64_t dv = sw128_desc(vs + c * TILE + kk * 2048, TILE, 1024);
          wgmma_rs(acc[c], ph[kk], dv);
          wgmma_rs(acc[c], pl[kk], dv);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < DC; ++c) reg_fence(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // the slot is free
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, sh);
    l1 += __shfl_xor_sync(FULL, l1, sh);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int hw = head_of(w);
  __nv_bfloat16* o0 = o + (((long long)bb * sq + r0) * h + hw) * d;
  __nv_bfloat16* o1 = o + (((long long)bb * sq + r1) * h + hw) * d;
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + cq;
      if (col >= d) continue;
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
            acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
      if (r1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
            acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (libcuda
// is loaded by the runtime already), so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, S, heads, D) bf16 tensor as a 4-D map (D innermost) read in
// 64 (D) x 1 x 64 (S) x 1 boxes, 128-byte swizzled, zeros out of bounds.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int b,
                  int s, int heads, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, int b, int sq, int sk, int h, int kvh, int d, int causal,
           float sl2, cudaStream_t stream) {
  const int smem = Smem<DC>::BYTES;
  auto kern = flash_attention_sm90_kernel<DC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const bool pair = (h / kvh) % 2 == 0;
  const long long n_qt = pair ? (sq + BM - 1) / BM
                              : (sq + CONSUMERS * BM - 1) / (CONSUMERS * BM);
  const long long n_hg = pair ? h / CONSUMERS : h;
  const long long blocks = n_qt * n_hg * b;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, b, sq, sk, h, kvh, d, causal, sl2,
      (int)n_qt, (int)n_hg);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes as in the header; d a multiple of 16 in [16, 256], h a multiple
// of kvh, every pointer 16-byte aligned (the wrapper checks).  scale_log2
// is log2(e) / sqrt(d).  Returns a cudaError_t code, or 1000 + the CUresult
// of a tensor-map encode that failed (1999 when that entry point is
// missing).
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* o, int b, int sq,
                                    int sk, int h, int kvh, int d, int causal,
                                    float scale_log2, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 || d < 16 ||
      d > 256 || d % 16 != 0 || (((uintptr_t)q | (uintptr_t)k |
                                   (uintptr_t)v | (uintptr_t)o) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return 1999;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, b, sq, h, d);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, k, b, sk, kvh, d);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, v, b, sk, kvh, d);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 63) / 64) {
    case 1: return launch<1>(tq, tk, tv, o, b, sq, sk, h, kvh, d, causal, scale_log2, s);
    case 2: return launch<2>(tq, tk, tv, o, b, sq, sk, h, kvh, d, causal, scale_log2, s);
    case 3: return launch<3>(tq, tk, tv, o, b, sq, sk, h, kvh, d, causal, scale_log2, s);
    case 4: return launch<4>(tq, tk, tv, o, b, sq, sk, h, kvh, d, causal, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
