// Native expert-data window sampler, the data-loader hot path of the
// PyTorch port's trainer (a copy of the JAX package's
// runtime/src/window_sampler.cpp, so that the port builds it without
// importing that package).
//
// Semantics (identical to the numpy sampler in learning/data.py):
//  - uniform random start indices into the concatenated dataset,
//    rejecting starts whose mask is 0 (episode ends);
//  - windows running past the data end are zero-padded;
//  - the returned mask is the cumulative product along the window.
//
// Parallelism: one task per batch element over a thread pool. RNG:
// SplitMix64 streams per element (deterministic given seed).
//
// Build (diff_qp_mpc_tpu_torch/runtime/__init__.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC -pthread \
//       -o libwindow_sampler.so window_sampler.cpp

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

void sample_one(const float* states, const float* actions, const float* mask,
                int64_t N, int64_t nx, int64_t nu, int64_t T, uint64_t seed,
                float* out_s, float* out_a, float* out_m) {
  SplitMix64 rng(seed);
  int64_t start = 0;
  for (int attempt = 0; attempt < 1024; ++attempt) {
    start = static_cast<int64_t>(rng.below(static_cast<uint64_t>(N)));
    if (mask[start] != 0.0f) break;  // never start at an episode end
  }
  const int64_t avail = (start + T <= N) ? T : (N - start);
  std::memcpy(out_s, states + start * nx, sizeof(float) * avail * nx);
  std::memcpy(out_a, actions + start * nu, sizeof(float) * avail * nu);
  if (avail < T) {
    std::memset(out_s + avail * nx, 0, sizeof(float) * (T - avail) * nx);
    std::memset(out_a + avail * nu, 0, sizeof(float) * (T - avail) * nu);
  }
  float cum = 1.0f;
  for (int64_t t = 0; t < T; ++t) {
    const float m = (t < avail) ? mask[start + t] : 0.0f;
    cum *= m;
    out_m[t] = cum;
  }
}

}  // namespace

extern "C" {

// states: [N, nx], actions: [N, nu], mask: [N] — contiguous float32.
// Outputs: out_states [bsz, T, nx], out_actions [bsz, T, nu],
// out_mask [bsz, T]. Deterministic for a given seed.
void sample_window_batch(const float* states, const float* actions,
                         const float* mask, int64_t N, int64_t nx, int64_t nu,
                         int64_t T, int64_t bsz, uint64_t seed,
                         float* out_states, float* out_actions,
                         float* out_mask) {
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t n_threads =
      std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, bsz));
  std::atomic<int64_t> next_idx{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next_idx.fetch_add(1);
      if (b >= bsz) return;
      sample_one(states, actions, mask, N, nx, nu, T,
                 seed * 0x9E3779B97F4A7C15ULL + static_cast<uint64_t>(b) + 1,
                 out_states + b * T * nx, out_actions + b * T * nu,
                 out_mask + b * T);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t i = 1; i < n_threads; ++i) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
}

}  // extern "C"
