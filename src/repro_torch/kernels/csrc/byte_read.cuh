// Shared device helper of the byte-key kernels: one big-endian key word of
// a byte-per-symbol string (the in-kernel form of
// repro_torch.core.packing.gather_pack).
#pragma once
#include <cstdint>

// The 32-bit key of symbols base .. base + 3 (base >= 0), most
// significant byte first, with every symbol index clamped to n_s - 1 as
// the plain version clamps.  Away from the end of the string the four
// bytes come from the two aligned 32-bit words that hold them, picked
// and byte-swapped by one __byte_perm; offsets are suffix positions and
// so are not 4-aligned.  `s` must be 4-byte aligned (the wrappers check).
__device__ __forceinline__ uint32_t byte_key_word(const uint8_t* __restrict__ s,
                                                  long long n_s,
                                                  long long base) {
  if (base + 8 <= n_s) {  // both aligned words lie inside the string
    long long a = base & ~3LL;
    uint32_t lo = __ldg(reinterpret_cast<const uint32_t*>(s + a));
    uint32_t hi = __ldg(reinterpret_cast<const uint32_t*>(s + a + 4));
    unsigned k = (unsigned)(base & 3);
    // result byte 3 (most significant) = memory byte k, ..., byte 0 = k + 3
    return __byte_perm(lo, hi, (k + 3) | ((k + 2) << 4) | ((k + 1) << 8) |
                                   (k << 12));
  }
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i) {
    long long idx = base + i;
    idx = idx < n_s - 1 ? idx : n_s - 1;
    w = (w << 8) | (uint32_t)__ldg(s + idx);
  }
  return w;
}
