// search_bounds_packed: the whole fixed-trip binary search of a batch of
// masked byte-key patterns over the suffix array of the DENSE text, in
// one launch.  Row r is pattern r mod B: rows < B give the lower bound
// (first suffix >= the pattern), rows >= B (bounds == 2) the upper bound
// (first suffix > it).
//
// Replaces the loop around the TPU kernel
// repro/kernels/packed_gather.py:pattern_probe_packed (:159, pallas_call
// at :196): the fori_loop of repro/core/query.py:_search_bounds (:114-149)
// on byte keys over dense text (a batch that carries the terminal code,
// and every search under REPRO_WORD_COMPARE=byte), which launches the
// probe n_iter times per batch (29 at n = 2^27) with a clamp, an ell
// gather and three selects around each, and the lower-bound loop of
// repro/core/analytics.py:_matching_stats (:106-117, bounds == 1).  Each
// row runs that loop's trips exactly (search.cuh bounds_kernel) with the
// compare of pattern_probe_packed.cu (probe_packed.cuh DenseText: byte
// keys spread from the dense words, the terminal byte patched in by
// position, masked keys compared unsigned, C5), so the result is
// bit-identical to the loop.
//
// Bound on the H100: dependent DRAM latency times trips, not bytes.  Each
// trip reads 4 B of ell and a dense word or few of the text at a position
// only the previous trip knows; a batch moves a few KB.  What the design
// does about it: one launch per search instead of n_iter; a template on
// BITS (2, 4, 8), so a key word's dense word, funnel shift and chunk are
// known at compile time; the pattern row read once, into registers for
// NW <= 16 (a template on NW: served rows of 4-24 symbols are 1-6 key
// words, the analytics window of 64 symbols 16) or into interleaved shared
// memory above (max_pattern_len 512 is 128 key words); every dense word of
// a trip's first chunk (16 key words at 2 bits, 8 at 4 and 8) loaded
// before its first compare, with an exit after each chunk; the next
// trip's two candidate ell entries loaded beside this trip's text read; a
// row stops as soon as its window is empty; 64-thread blocks spread a
// batch over more SMs.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_packed.cuh"
#include "search.cuh"

extern "C" int search_bounds_packed(const void* words, long long n_words,
                                    const void* ell, long long total,
                                    const void* pat, const void* mask,
                                    const void* lo0, const void* hi0,
                                    long long b, int bounds, int nw,
                                    int n_iter, int bits, long long n_real,
                                    unsigned int t_word, void* out,
                                    void* stream) {
  if (b * bounds == 0) return 0;
  if (nw <= 0 || total <= 0 || n_words <= 0)
    return (int)cudaErrorInvalidValue;
  const auto run = [&](auto text) {
    const search::BoundsArgs<decltype(text)> a{
        text, (const int32_t*)ell, total, (const uint32_t*)pat,
        (const uint32_t*)mask, (const int32_t*)lo0, (const int32_t*)hi0, b,
        bounds, nw, n_iter, (int32_t*)out};
    return (int)search::launch_bounds(a, (cudaStream_t)stream);
  };
  const uint32_t* w = (const uint32_t*)words;
  if (bits == 2) return run(packed::DenseText<2>{w, n_words, n_real, t_word});
  if (bits == 4) return run(packed::DenseText<4>{w, n_words, n_real, t_word});
  if (bits == 8) return run(packed::DenseText<8>{w, n_words, n_real, t_word});
  return (int)cudaErrorInvalidValue;
}
