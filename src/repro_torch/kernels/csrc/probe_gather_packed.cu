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
// words for both halves.  Here one thread per row makes
// nw_rd = max(W, fetch/4) key words with dense_read.cuh: one shift-aligned
// dense_read_word (sub_word 0) per 8/bits key words, each key word spread
// to bytes and terminal-patched by dense_key_word.  The first fetch/4 go
// to the window, the first W are masked and compared unsigned; the compare
// stops at its first difference, the read once the window is written too.
//
// Bound on the H100: launch latency at serving shapes, as the probes: a
// batch of B rows moves B * (ceil(4 * nw_rd / spw) + 1) text words,
// 2 * B * W pattern and mask words, B positions and B * (fetch/4 + 1)
// output words, a few KB at B = 256 and fetch = 32.  At large row counts
// the scattered text reads and the window stores bound it.
#include <cuda_runtime.h>
#include <cstdint>

#include "dense_read.cuh"

__global__ void probe_gather_packed_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ pat,
    const uint32_t* __restrict__ mask, long long b, int nw_pat, int nw_out,
    int bits, long long n_real, uint32_t t_word, int32_t* __restrict__ cmp,
    uint32_t* __restrict__ keys) {
  const int spw = 32 / bits;
  const int cpw = spw / 4;  // key words per dense word
  const int nw_rd = nw_pat > nw_out ? nw_pat : nw_out;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += (long long)gridDim.x * blockDim.x) {
    long long p0 = pos[i];
    int v = 0;
    bool open = true;  // no differing key word found yet
    uint32_t aligned = 0u;
    for (int j = 0; j < nw_rd; ++j) {
      if (j >= nw_out && !open) break;  // window written, verdict decided
      if (j % cpw == 0)  // positions past n_real are patched, so sub = 0
        aligned = dense_read_word(words, n_words, p0, j / cpw, bits, spw,
                                  n_real, 0u);
      uint32_t key = dense_key_word(aligned, j, bits, p0, n_real, t_word);
      if (j < nw_out) keys[i * nw_out + j] = key;
      if (open && j < nw_pat) {
        uint32_t sw = key & mask[i * nw_pat + j];
        uint32_t pw = pat[i * nw_pat + j];
        if (sw != pw) {
          v = sw < pw ? -1 : 1;
          open = false;
        }
      }
    }
    cmp[i] = v;
  }
}

extern "C" int probe_gather_packed(const void* words, long long n_words,
                                   const void* pos, const void* pat,
                                   const void* mask, long long b, int nw_pat,
                                   int nw_out, int bits, long long n_real,
                                   unsigned int t_word, void* cmp, void* keys,
                                   void* stream) {
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  probe_gather_packed_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)pos,
      (const uint32_t*)pat, (const uint32_t*)mask, b, nw_pat, nw_out, bits,
      n_real, (uint32_t)t_word, (int32_t*)cmp, (uint32_t*)keys);
  return (int)cudaGetLastError();
}
