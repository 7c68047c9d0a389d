// Native host-side batch assembly for the host-fed input pipeline (a copy
// of mimo_unet_tpu/data/_native/gather.cc).
//
// The reference feeds its GPU through torch DataLoader worker *processes*
// (reference: mimo/tasks/depth/nyuv2_datamodule.py:52-60).  Here the hot
// host path is vectorized batch slicing of RAM-resident arrays; numpy's
// fancy indexing is a single-threaded memcpy, which can starve the card at
// large batch sizes.  These two kernels do the same copies with a small
// thread pool:
//
//   gather_rows:    dst[i] = src[idx[i]]            (dataset batch slicing)
//   gather_patches: dst[i] = tiles[t[i]][y[i]:y[i]+ph, x[i]:x[i]+pw, :]
//                                                   (SEN12TP windowing)
//
// Plain C ABI (called via ctypes); bytes are copied irrespective of dtype
// (row sizes are given in bytes).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Simple static-partition parallel-for over [0, n).
template <typename F>
void parallel_for(int64_t n, int num_threads, F&& fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  int threads = static_cast<int>(
      std::min<int64_t>(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  std::atomic<int64_t> next(0);
  constexpr int64_t kChunk = 4;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      while (true) {
        int64_t start = next.fetch_add(kChunk);
        if (start >= n) break;
        int64_t end = std::min(start + kChunk, n);
        for (int64_t i = start; i < end; ++i) fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// dst[i * row_bytes : ...] = src[idx[i] * row_bytes : ...] for i in [0, n)
void mimo_gather_rows(const char* src, const int64_t* idx, char* dst,
                      int64_t n, int64_t row_bytes, int num_threads) {
  parallel_for(n, num_threads, [=](int64_t i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
  });
}

// tiles: [n_tiles, tile_h, tile_w, ch] contiguous, element size elem_bytes.
// For each window i: copy [ph, pw, ch] starting at (ys[i], xs[i]) of tile
// tidx[i] into dst[i].
void mimo_gather_patches(const char* tiles, int64_t tile_h, int64_t tile_w,
                         int64_t ch, int64_t elem_bytes, const int64_t* tidx,
                         const int64_t* ys, const int64_t* xs, int64_t n,
                         int64_t ph, int64_t pw, char* dst, int num_threads) {
  const int64_t tile_row_bytes = tile_w * ch * elem_bytes;
  const int64_t tile_bytes = tile_h * tile_row_bytes;
  const int64_t patch_row_bytes = pw * ch * elem_bytes;
  const int64_t patch_bytes = ph * patch_row_bytes;
  parallel_for(n, num_threads, [=](int64_t i) {
    const char* tile = tiles + tidx[i] * tile_bytes;
    const char* src0 =
        tile + ys[i] * tile_row_bytes + xs[i] * ch * elem_bytes;
    char* out = dst + i * patch_bytes;
    for (int64_t r = 0; r < ph; ++r) {
      std::memcpy(out + r * patch_row_bytes, src0 + r * tile_row_bytes,
                  patch_row_bytes);
    }
  });
}

}  // extern "C"
