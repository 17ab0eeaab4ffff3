// probe_gather_packed: find-and-fetch in one launch in the byte-key
// currency over the dense text.  Per row, the -1/0/+1 verdict of
// pattern_probe_packed.cu AND the fetch/4 big-endian byte key words that
// range_gather_packed.cu returns at the same position (the terminal byte
// past n_real), bit-identical to the byte probe and range_gather_pack on
// the terminal-padded byte string.
//
// Replaces the TPU kernel repro/kernels/probe_gather.py:probe_gather_packed
// (pallas_call at :217; body _fused_packed_kernel, :148-170), which DMAs a
// (2, tile) window of the staged words per row, expands every field to a
// symbol, patches the virtual terminal and repacks max(W, fetch/4) key
// words for both halves.  Here one thread per row runs the compare of
// probe_packed.cuh (the pattern's key words masked and compared unsigned
// up to the first difference), then reads the fetch/4 window key words
// with the same code (each chunk's dense words loaded together, mostly
// the lines the compare has just read); a template on BITS.
//
// Bound on the H100: launch latency at serving shapes, as the probes: a
// batch of B rows moves B * (ceil(4 * nw_rd / spw) + 1) text words,
// 2 * B * W pattern and mask words, B positions and B * (fetch/4 + 1)
// output words, a few KB at B = 256 and fetch = 32.  At large row counts
// the scattered text reads and the window stores bound it.  Find-and-fetch
// runs in search_fetch_packed.cu (search, verdict and decoded window in
// one launch); this kernel stays as the TPU kernel's counterpart and the
// unfused epilogue it is timed against.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_packed.cuh"

template <int BITS>
__global__ void probe_gather_packed_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, long long b, int nw_pat, int nw_out,
    long long n_real, uint32_t t_word, int32_t* __restrict__ cmp,
    uint32_t* __restrict__ keys) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p0 = pos[i];
    const GlobalRow row{pat + i * nw_pat, mask + i * nw_pat};
    cmp[i] = packed::probe_packed_verdict<BITS, 0>(
        words, n_words, p0, row, nw_pat, packed::live_words<0>(row, nw_pat),
        n_real, t_word);
    uint32_t* out = keys + i * nw_out;
    packed::read_keys<BITS>(words, n_words, p0, n_real, 0, nw_out, t_word,
                            [&](int g, uint32_t w) { out[g] = w; });
  }
}

template <int BITS>
static cudaError_t launch(const void* words, long long n_words,
                          const void* pos, const void* pat, const void* mask,
                          long long b, int nw_pat, int nw_out,
                          long long n_real, uint32_t t_word, void* cmp,
                          void* keys, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  probe_gather_packed_kernel<BITS><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos,
      (const uint32_t*)pat, (const uint32_t*)mask, b, nw_pat, nw_out, n_real,
      t_word, (int32_t*)cmp, (uint32_t*)keys);
  return cudaGetLastError();
}

extern "C" int probe_gather_packed(const void* words, long long n_words,
                                   const void* pos, const void* pat,
                                   const void* mask, long long b, int nw_pat,
                                   int nw_out, int bits, long long n_real,
                                   unsigned int t_word, void* cmp, void* keys,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (b == 0) return 0;
  if (bits == 2)
    return (int)launch<2>(words, n_words, pos, pat, mask, b, nw_pat, nw_out,
                          n_real, t_word, cmp, keys, s);
  if (bits == 4)
    return (int)launch<4>(words, n_words, pos, pat, mask, b, nw_pat, nw_out,
                          n_real, t_word, cmp, keys, s);
  if (bits == 8)
    return (int)launch<8>(words, n_words, pos, pat, mask, b, nw_pat, nw_out,
                          n_real, t_word, cmp, keys, s);
  return (int)cudaErrorInvalidValue;
}
