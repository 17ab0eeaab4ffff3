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
// search_fetch_words.cu, whose design this kernel shares (search.cuh
// fetch_kernel over the ByteText policy of probe_bytes.cuh): lanes 2k and
// 2k + 1 search pattern k's lower and upper bound, one __shfl_xor_sync
// pairs them, both read ell[clamp(llo)] once; the lower lane takes the
// verdict and the first half of the window's key words, the upper lane
// the second half, each key word (byte_read.cuh) split into four codes and
// written as one 16-byte store.
#include <cuda_runtime.h>
#include <cstdint>

#include "probe_bytes.cuh"
#include "search.cuh"

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
  const search::FetchArgs<ByteText> a{
      ByteText{(const uint8_t*)s, n_s}, (const int32_t*)ell, total,
      (const uint32_t*)pat, (const uint32_t*)mask, (const int32_t*)lo0,
      (const int32_t*)hi0, b, nw, n_iter, fetch, (int32_t*)start,
      (int32_t*)count, (int32_t*)window, (int32_t*)verified};
  return (int)search::launch_fetch(a, (cudaStream_t)stream);
}
