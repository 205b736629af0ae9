// K5: saturated float32 sin throughput, one thread per output element.
//
// Replaces the TPU kernel benchmarks/roofline_fused.py::transcendental_rate
// (_sin_chain_kernel). Same function: x [n_tiles, S, 8, 128] → out
// [n_tiles, 8, 128], each element's S streams put through sin n_ops times,
// then summed in stream order, o = xs[0] + xs[1] + … + xs[S−1].
//
// Design: thread e takes element e of the flattened [n_tiles, 8·128] output
// (neighbouring threads on neighbouring lanes of a tile, so loads and
// stores coalesce) and keeps its S chains in registers; the chains are
// independent, so the FP32 pipes overlap them. S is a template parameter
// (1 to 8), n_ops a run-time argument; the chain loop is unrolled by 4.
// At the defaults (4096 tiles) that is 4.2 M threads, enough blocks to fill
// the 132 SMs many times over.
//
// The sin is the overload on float that K2's pendulum functor calls
// (al_fused.cu, PendulumDyn::step), compiled without --use_fast_math: a
// range reduction and polynomials on the FP32 pipes, not the SFU's
// MUFU.SIN that __sinf would use and K2 never does. The rate measured is
// then the rate K2's dynamics can reach. Inputs stay in (0, 1), so every
// sin takes the fast path (the slow Payne-Hanek reduction is for |x| above
// ~1e5); so does the pendulum's θ in K2.
//
// Bound on the H100: by operations. Each sin is 15 FP32 instructions on its
// fast path (benchmarks/flops.py::SINF_FP32_INSTR, read from the SASS)
// against 4 bytes per chain read once.
#include <cmath>
#include <cstddef>

#include <cuda_runtime.h>

namespace dqmpc {

constexpr int kTile = 8 * 128;

template <int S>
__global__ void __launch_bounds__(256)
sin_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n_elems, int n_ops) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long tile = e / kTile, lane = e % kTile;
  float xs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) xs[s] = x[(tile * S + s) * kTile + lane];
#pragma unroll 4
  for (int k = 0; k < n_ops; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) xs[s] = sin(xs[s]);
  }
  float o = xs[0];
#pragma unroll
  for (int s = 1; s < S; ++s) o = o + xs[s];
  out[e] = o;
}

template <int S>
int launch(const float* x, float* out, long long n_elems, int n_ops,
           cudaStream_t s) {
  const int threads = 256;
  const long long blocks = (n_elems + threads - 1) / threads;
  sin_chain_kernel<S><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      x, out, n_elems, n_ops);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dqmpc

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [n_tiles, n_streams, 8, 128] → out [n_tiles, 8, 128], float32,
// contiguous; n_streams in 1..8. Returns a cudaError_t code;
// cudaErrorInvalidValue for another n_streams.
extern "C" int sin_chain_f32(const void* x, void* out, int n_tiles,
                             int n_streams, int n_ops, void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const long long n = static_cast<long long>(n_tiles) * dqmpc::kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_streams) {
    case 1: return dqmpc::launch<1>(xp, op, n, n_ops, s);
    case 2: return dqmpc::launch<2>(xp, op, n, n_ops, s);
    case 3: return dqmpc::launch<3>(xp, op, n, n_ops, s);
    case 4: return dqmpc::launch<4>(xp, op, n, n_ops, s);
    case 5: return dqmpc::launch<5>(xp, op, n, n_ops, s);
    case 6: return dqmpc::launch<6>(xp, op, n, n_ops, s);
    case 7: return dqmpc::launch<7>(xp, op, n, n_ops, s);
    case 8: return dqmpc::launch<8>(xp, op, n, n_ops, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
