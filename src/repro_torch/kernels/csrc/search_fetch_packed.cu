// search_fetch_packed: the whole find-and-fetch of a batch of masked
// byte-key patterns over the suffix array of the DENSE text, in one
// launch.  Per pattern: the lower and upper bound search of
// search_bounds_packed.cu, then at the first match ell[clamp(start)] the
// verdict of pattern_probe_packed.cu and the fetch symbols there, decoded
// to int32 codes (the dense field below n_real, the terminal from n_real
// on; -1 rows where nothing matched).
//
// Replaces the TPU composition repro/core/query.py:_find_fetch_batch
// (:207) on byte keys over dense text (a batch that carries the terminal
// code, and every find-and-fetch under REPRO_WORD_COMPARE=byte): the
// fori_loop of _search_bounds (:114-149) around
// repro/kernels/packed_gather.py:pattern_probe_packed (:159), then
// repro/kernels/probe_gather.py:probe_gather_packed (:174, pallas_call at
// :217) at each lower bound and _window_symbols (:178).  It is
// bit-identical to that composition, which is what
// repro_torch.kernels.search.search_fetch_packed runs on CPU tensors:
// start = llo, count = max(ulo - llo, 0), the verdict written for every
// row (count == 0 rows at the clamped position), the window the same
// codes every other storage and leg decodes.
//
// Bound on the H100: dependent DRAM latency times trips, not bytes, as in
// search_fetch_words.cu and search_fetch_bytes.cu, whose design and code
// this kernel shares (search.cuh fetch_kernel over the DenseText policy of
// probe_packed.cuh: a template on BITS, the pattern row in registers for
// NW <= 16 and in interleaved shared memory above, each trip's chunk of
// dense words loaded together): lanes 2k and 2k + 1 search pattern k's
// lower and upper bound, one __shfl_xor_sync pairs them, both read
// ell[clamp(llo)] once; the lower lane takes the verdict and the first
// half of the window's key words, the upper lane the second half; each
// key word (the dense words under it read a chunk at a time, spread to
// bytes, the terminal patched in by position) is split into four codes in
// registers and written as one 16-byte store.  Every lane of a warp stays
// in the grid-stride loop until the shuffle (rows past 2B are inactive but
// reach it), since lanes leave the search after different trip counts.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_packed.cuh"
#include "search.cuh"

extern "C" int search_fetch_packed(
    const void* words, long long n_words, const void* ell, long long total,
    const void* pat, const void* mask, const void* lo0, const void* hi0,
    long long b, int nw, int n_iter, int bits, long long n_real,
    unsigned int t_word, int fetch, void* start, void* count, void* window,
    void* verified, void* stream) {
  if (b == 0) return 0;
  if (fetch <= 0 || fetch % 4 || nw <= 0 || total <= 0 || n_words <= 0)
    return (int)cudaErrorInvalidValue;
  const auto run = [&](auto text) {
    const search::FetchArgs<decltype(text)> a{
        text, (const int32_t*)ell, total, (const uint32_t*)pat,
        (const uint32_t*)mask, (const int32_t*)lo0, (const int32_t*)hi0, b,
        nw, n_iter, fetch, (int32_t*)start, (int32_t*)count,
        (int32_t*)window, (int32_t*)verified};
    return (int)search::launch_fetch(a, (cudaStream_t)stream);
  };
  const uint32_t* w = (const uint32_t*)words;
  if (bits == 2) return run(packed::DenseText<2>{w, n_words, n_real, t_word});
  if (bits == 4) return run(packed::DenseText<4>{w, n_words, n_real, t_word});
  if (bits == 8) return run(packed::DenseText<8>{w, n_words, n_real, t_word});
  return (int)cudaErrorInvalidValue;
}
