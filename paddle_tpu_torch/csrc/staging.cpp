// Host staging / collation: the native data path of the port's DataLoader
// (a host C++ copy of paddle_tpu/native/staging.cpp, built with g++ by
// paddle_tpu_torch/native/__init__.py; not a device kernel).
//
// Reference analog: the C++ side of Paddle's input pipeline -- pinned host
// staging buffers (memory/allocation/pinned_allocator.cc), the double-buffer
// H2D prefetch reader (operators/reader/buffered_reader.cc), and the
// DataLoader worker collation done outside Python
// (fluid/dataloader/... over core._convert_to_tensor_list).
//
// It assembles many per-sample buffers into one contiguous,
// transfer-ready batch without the GIL, and fuses the ubiquitous
// uint8->float32 scale/shift (vision normalize) into that same pass.
// Threads split the batch by sample; each memcpy/convert runs GIL-free
// (callers release it via ctypes).
//
// Exported C ABI (consumed by paddle_tpu_torch/native/__init__.py ctypes):
//   pt_stack(dst, srcs, n, sample_bytes, n_threads)
//   pt_stack_u8_to_f32(dst, srcs, n, sample_elems, scale, shift, n_threads)
//   pt_version()

#include <cstdint>
#include <functional>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static void run_sharded(int64_t n, int n_threads,
                        const std::function<void(int64_t, int64_t)> &fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  int workers = n_threads < (int)n ? n_threads : (int)n;
  std::vector<std::thread> pool;
  pool.reserve(workers);
  int64_t chunk = (n + workers - 1) / workers;
  for (int t = 0; t < workers; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto &th : pool) th.join();
}

// Stack n equal-size sample buffers into one contiguous batch buffer.
void pt_stack(uint8_t *dst, const uint8_t **srcs, int64_t n,
              int64_t sample_bytes, int n_threads) {
  run_sharded(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * sample_bytes, srcs[i], (size_t)sample_bytes);
    }
  });
}

// Stack + fused uint8 -> float32 `x * scale + shift` (vision normalize).
void pt_stack_u8_to_f32(float *dst, const uint8_t **srcs, int64_t n,
                        int64_t sample_elems, float scale, float shift,
                        int n_threads) {
  run_sharded(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t *src = srcs[i];
      float *out = dst + i * sample_elems;
      for (int64_t j = 0; j < sample_elems; ++j) {
        out[j] = (float)src[j] * scale + shift;
      }
    }
  });
}

int pt_version() { return 1; }

}  // extern "C"
