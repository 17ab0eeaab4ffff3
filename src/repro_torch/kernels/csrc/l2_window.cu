// A persisting L2 access-policy window on a stream, for measurement only:
// no kernel of the port sets one.
//
// A window marks up to persistingL2CacheMaxSize bytes of a buffer's lines
// as persisting (hitRatio = that size over the window), so that streaming
// traffic cannot evict them.  On the H100 the set-aside it needs slows
// every other kernel on the card while it is held, so the window is set
// around the launches it measures and taken off right after: the stream's
// window and the device's persisting limit go back to what they were, and
// the lines marked persisting return to normal.
#include <cuda_runtime.h>

#include <cstddef>

static cudaStreamAttrValue g_prev_window;
static size_t g_prev_limit = 0;
static bool g_set = false;

// Raise the persisting set-aside to its maximum and set a window over
// [base, base + bytes) on the stream; *hit_ratio gets the ratio used
// (0 where the card has no persisting L2 and nothing was set).
extern "C" int l2_window_set(void* stream, const void* base,
                             long long bytes, float* hit_ratio) {
  cudaStream_t st = (cudaStream_t)stream;
  *hit_ratio = 0.0f;
  if (g_set) return (int)cudaErrorInvalidValue;  // one window at a time
  int dev = 0, max_persist = 0, max_window = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize,
                         dev);
  cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                         dev);
  if (max_persist <= 0 || max_window <= 0 || bytes <= 0) return 0;
  err = cudaDeviceGetLimit(&g_prev_limit, cudaLimitPersistingL2CacheSize);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetAttribute(st, cudaStreamAttributeAccessPolicyWindow,
                               &g_prev_window);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                           (size_t)max_persist);
  if (err != cudaSuccess) return (int)err;
  size_t nb = (size_t)bytes < (size_t)max_window ? (size_t)bytes
                                                 : (size_t)max_window;
  cudaStreamAttrValue v = {};
  v.accessPolicyWindow.base_ptr = const_cast<void*>(base);
  v.accessPolicyWindow.num_bytes = nb;
  float ratio = (float)max_persist / (float)nb;
  v.accessPolicyWindow.hitRatio = ratio < 1.0f ? ratio : 1.0f;
  v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  err = cudaStreamSetAttribute(st, cudaStreamAttributeAccessPolicyWindow, &v);
  if (err != cudaSuccess) {
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, g_prev_limit);
    return (int)err;
  }
  g_set = true;
  *hit_ratio = v.accessPolicyWindow.hitRatio;
  return 0;
}

// Take the window off: wait for the stream, put its previous window and
// the previous persisting limit back, and return persisting lines to
// normal.
extern "C" int l2_window_clear(void* stream) {
  if (!g_set) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  g_set = false;
  cudaError_t err = cudaStreamSynchronize(st);
  cudaError_t e = cudaStreamSetAttribute(
      st, cudaStreamAttributeAccessPolicyWindow, &g_prev_window);
  if (err == cudaSuccess) err = e;
  e = cudaCtxResetPersistingL2Cache();
  if (err == cudaSuccess) err = e;
  e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, g_prev_limit);
  if (err == cudaSuccess) err = e;
  return (int)err;
}

// What a stream and the device hold now: the window's bytes (0: none) and
// the persisting set-aside's bytes.
extern "C" int l2_window_state(void* stream, long long* window_bytes,
                               long long* limit_bytes) {
  cudaStreamAttrValue v = {};
  size_t limit = 0;
  cudaError_t err = cudaStreamGetAttribute(
      (cudaStream_t)stream, cudaStreamAttributeAccessPolicyWindow, &v);
  cudaError_t e = cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  *window_bytes = (long long)v.accessPolicyWindow.num_bytes;
  *limit_bytes = (long long)limit;
  return (int)(err != cudaSuccess ? err : e);
}
