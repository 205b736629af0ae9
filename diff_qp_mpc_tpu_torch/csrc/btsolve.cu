// K1: batched block-tridiagonal Cholesky factor + solve, H x = b.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/btsolve_pallas.py::
// batched_factor_solve (_factor_solve_kernel). Same function:
//   L₀L₀ᵀ = D₀ + reg·I;  Sₜ = Oₜ₋₁Lₜ₋₁⁻ᵀ;  LₜLₜᵀ = Dₜ − SₜSₜᵀ + reg·I,
// then block forward (L y = b) and backward (Lᵀ x = y) substitution.
//
// Bound on the H100: at the main path's shapes (B = 64 .. 4096, T = 5,
// n = 3) the work is ~500 flops and ~450 bytes per element, so the card's
// bound is the bytes; but B is far below the 132 SMs × 2048 threads the
// card holds, so a launch is latency-bound: one serial O(T n³) chain per
// thread, whose links are the IEEE divisions and square roots of each
// stage and, in a streaming layout, the global loads of each stage.
//
// Two layouts, one thread per batch element in both; the wrapper
// (ops/btsolve_cuda.py) picks one by (dtype, n, T):
// - on chip (btsolve_onchip_kernel, n and T template parameters): a block's
//   elements are contiguous in D, O and b, so its threads first copy the
//   block's spans into shared memory together (coalesced; each element's
//   row padded to an odd number of words, so the per-thread reads hit
//   distinct banks in float32 and float64). Each thread then runs its
//   element's sweep from shared memory with every stage unrolled, holds
//   Lₜ, Sₜ and yₜ in registers for the backward sweep (no scratch tensor),
//   writes x over b in shared memory, and the block copies x out coalesced.
//   The arithmetic and its order are the streaming kernel's, so the two
//   layouts' outputs are bit-identical. (One reciprocal per pivot in place
//   of the divisions ran 34% faster at B 64 but moved float32 solutions of
//   the AL path's ρ ≥ 1e4 systems past K1's tolerance; see PERF.md.)
// - streaming (btsolve_kernel, n a template parameter, T a run-time value):
//   every other shape. The forward substitution runs inside the factor
//   sweep, and the factor's Lₜ and Sₜ go to a batch-minor scratch tensor
//   [2][T][n][n][B] for the backward sweep; y is parked in the output x.
//   float32 at n 16 (the quadrotor) computes in float64 (Compute, below):
//   its scratch holds float64 and a third part [T][n][B] where y is parked.
//
// Why n 16 computes wider, unlike the TPU kernel and the plain version
// (both float32 throughout): the quadrotor's AL Newton systems at its
// checkpoint's ρ 1e4 (reg 1e-7, cond(H) ~1e7) leave float32 arithmetic
// with errors of the order of the solution: against the float64 solution,
// a float32 kernel and the plain float32 version each err by 0.2-0.7 of
// its largest entry at the worst element of a batch, element by element
// as often one as the other (a card probe, PERF.md), so which of the two
// errs more at a batch's worst element is a draw, and the float32 kernel
// drew 3.9 times the plain version's error at B 128. Computing in float64
// leaves the error of rounding the systems to float32 (~0.1 there), at
// 4-6 times the float32 computation's time (1.25 against 0.29 ms at B 64
// on an H100 80GB HBM3 at 700 W, PERF.md).
#include <cstddef>
#include <type_traits>

#include "bt_common.cuh"

namespace dqmpc {

// the type the streaming kernel's (N, F) instantiation computes in
template <int N, typename F>
struct Compute {
  using type = F;
};
template <>
struct Compute<16, float> {
  using type = double;
};

template <int N, typename F, typename C = typename Compute<N, F>::type>
__global__ void __launch_bounds__(128)
btsolve_kernel(const F* __restrict__ D, const F* __restrict__ O,
               const F* __restrict__ b, F* __restrict__ x,
               C* __restrict__ scratch, int B, int T, C reg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  constexpr int NN = N * N;
  const F* De = D + static_cast<size_t>(e) * T * NN;
  const F* Oe = O + static_cast<size_t>(e) * (T - 1) * NN;
  const F* be = b + static_cast<size_t>(e) * T * N;
  F* xe = x + static_cast<size_t>(e) * T * N;
  // scratch entry (which, t, i, j) of element e; which 0 = L, 1 = S
  auto at = [&](int which, int t, int i, int j) -> C& {
    return scratch[(((static_cast<size_t>(which) * T + t) * N + i) * N + j) *
                       B + e];
  };
  // where y is parked for the backward sweep: the output x, or, computing
  // wider than F, the scratch's third part
  auto park = [&](int t, int i) -> C& {
    if constexpr (std::is_same_v<C, F>) {
      return xe[t * N + i];
    } else {
      return scratch[((static_cast<size_t>(2 * T * N) * N) + t * N + i) * B +
                     e];
    }
  };

  C M[N][N], L[N][N], Lp[N][N], S[N][N], v[N], y[N], yp[N];

  // ---- stage 0: factor, forward solve ----
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) M[i][j] = De[i * N + j];
    M[i][i] = M[i][i] + reg;
  }
  chol<N, C>(M, L);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = be[i];
  solve_lower_vec<N, C>(L, v, y);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      at(0, 0, i, j) = L[i][j];
      Lp[i][j] = L[i][j];
    }
    park(0, i) = y[i];
    yp[i] = y[i];
  }

  // ---- stages 1..T-1: Sₜ, Schur complement, factor, forward solve ----
  for (int t = 1; t < T; ++t) {
    const F* Ot = Oe + static_cast<size_t>(t - 1) * NN;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) M[i][j] = Ot[i * N + j];
    }
    solve_lower_mat<N, C>(Lp, M, S);
    const F* Dt = De + static_cast<size_t>(t) * NN;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = Dt[i * N + j];
    }
    schur_update<N, C>(M, S, reg);
    chol<N, C>(M, L);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      C s = be[t * N + i];
#pragma unroll
      for (int k = 0; k < N; ++k) s = s - S[i][k] * yp[k];
      v[i] = s;
    }
    solve_lower_vec<N, C>(L, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) at(1, t, i, j) = S[i][j];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        at(0, t, i, j) = L[i][j];
        Lp[i][j] = L[i][j];
      }
      park(t, i) = y[i];
      yp[i] = y[i];
    }
  }

  // ---- backward: Lᵀ x = y; Lp, yp hold stage T-1 ----
  C xn[N];
  solve_upper_vec<N, C>(Lp, yp, xn);
#pragma unroll
  for (int i = 0; i < N; ++i) xe[(T - 1) * N + i] = static_cast<F>(xn[i]);
  for (int t = T - 2; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) S[i][j] = at(1, t + 1, i, j);
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = at(0, t, i, j);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      C s = park(t, i);
#pragma unroll
      for (int k = 0; k < N; ++k) s = s - S[k][i] * xn[k];
      v[i] = s;
    }
    solve_upper_vec<N, C>(L, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xe[t * N + i] = static_cast<F>(y[i]);
      xn[i] = y[i];
    }
  }
}

// threads per block of the on-chip kernel: a block stages 64 elements
constexpr int kOnChipThreads = 64;

// Words of one element in shared memory: D [T][N][N], O [T-1][N][N], b
// [T][N] (then x), rounded up to an odd count.
template <int N, int T>
struct OnChip {
  static constexpr int kD = T * N * N;
  static constexpr int kO = (T - 1) * N * N;
  static constexpr int kB = T * N;
  static constexpr int kStride = (kD + kO + kB) | 1;
};

// Copy the block's nb elements of K contiguous scalars each between global
// memory g and their rows (STRIDE apart, from column OFF) in shared memory,
// neighbouring threads on neighbouring global addresses: into shared
// memory when g points to const, out of it otherwise.
template <int K, int STRIDE, int OFF, typename P, typename F>
__device__ __forceinline__ void stage(P g, F* sm, int nb) {
  auto move = [&](int i) {
    F& s = sm[(i / K) * STRIDE + OFF + i % K];
    if constexpr (std::is_const_v<std::remove_pointer_t<P>>) {
      s = g[i];
    } else {
      g[i] = s;
    }
  };
  if (nb == kOnChipThreads) {
#pragma unroll
    for (int r = 0; r < K; ++r) move(r * kOnChipThreads + threadIdx.x);
  } else {
    for (int i = threadIdx.x; i < nb * K; i += kOnChipThreads) move(i);
  }
}

template <int N, int T, typename F>
__global__ void __launch_bounds__(kOnChipThreads)
btsolve_onchip_kernel(const F* __restrict__ D, const F* __restrict__ O,
                      const F* __restrict__ b, F* __restrict__ x, int B,
                      F reg) {
  using C = OnChip<N, T>;
  constexpr int NN = N * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* sm = reinterpret_cast<F*>(smem_raw);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * kOnChipThreads;
  const int nb = min(kOnChipThreads, B - static_cast<int>(e0));
  stage<C::kD, C::kStride, 0>(D + e0 * C::kD, sm, nb);
  stage<C::kO, C::kStride, C::kD>(O + e0 * C::kO, sm, nb);
  stage<C::kB, C::kStride, C::kD + C::kO>(b + e0 * C::kB, sm, nb);
  __syncthreads();

  if (threadIdx.x < nb) {
    const F* De = sm + threadIdx.x * C::kStride;
    const F* Oe = De + C::kD;
    F* be = sm + threadIdx.x * C::kStride + C::kD + C::kO;  // b, then x
    F L[T][N][N], S[T][N][N], y[T][N], M[N][N], v[N];

    // ---- stage 0: factor, forward solve ----
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = De[i * N + j];
      M[i][i] = M[i][i] + reg;
    }
    chol<N, F>(M, L[0]);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = be[i];
    solve_lower_vec<N, F>(L[0], v, y[0]);

    // ---- stages 1..T-1: Sₜ, Schur complement, factor, forward solve ----
#pragma unroll
    for (int t = 1; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) M[i][j] = Oe[(t - 1) * NN + i * N + j];
      }
      solve_lower_mat<N, F>(L[t - 1], M, S[t]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) M[i][j] = De[t * NN + i * N + j];
      }
      schur_update<N, F>(M, S[t], reg);
      chol<N, F>(M, L[t]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        F s = be[t * N + i];
#pragma unroll
        for (int k = 0; k < N; ++k) s = s - S[t][i][k] * y[t - 1][k];
        v[i] = s;
      }
      solve_lower_vec<N, F>(L[t], v, y[t]);
    }

    // ---- backward: Lᵀ x = y, x over b in shared memory ----
    F xn[N];
    auto bwd = [&](int t, const F (&rhs)[N]) {
      solve_upper_vec<N, F>(L[t], rhs, xn);
#pragma unroll
      for (int i = 0; i < N; ++i) be[t * N + i] = xn[i];
    };
    bwd(T - 1, y[T - 1]);
#pragma unroll
    for (int t = T - 2; t >= 0; --t) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        F s = y[t][i];
#pragma unroll
        for (int k = 0; k < N; ++k) s = s - S[t + 1][k][i] * xn[k];
        v[i] = s;
      }
      bwd(t, v);
    }
  }
  __syncthreads();
  stage<C::kB, C::kStride, C::kD + C::kO>(x + e0 * C::kB, sm, nb);
}

template <int N, int T, typename F>
int launch_onchip(const F* D, const F* O, const F* b, F* x, int B, F reg,
                  cudaStream_t s) {
  constexpr size_t smem =
      sizeof(F) * OnChip<N, T>::kStride * kOnChipThreads;
  auto kernel = btsolve_onchip_kernel<N, T, F>;
  if (smem > 48 * 1024) {  // above the default, as dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return static_cast<int>(err);
    }
  }
  const int blocks = (B + kOnChipThreads - 1) / kOnChipThreads;
  kernel<<<blocks, kOnChipThreads, smem, s>>>(D, O, b, x, B, reg);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_onchip_shape(const void* D, const void* O, const void* b, void* x,
                        int B, int T, int n, double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F* Dp = static_cast<const F*>(D);
  const F* Op = static_cast<const F*>(O);
  const F* bp = static_cast<const F*>(b);
  F* xp = static_cast<F*>(x);
  const F r = static_cast<F>(reg);
#define BT_ONCHIP_CASE(NN_, TT_) \
  if (n == NN_ && T == TT_)      \
    return launch_onchip<NN_, TT_, F>(Dp, Op, bp, xp, B, r, s);
  // the shapes whose element fits in registers without spills (ptxas -v:
  // float32 (3, 5) 96 registers, (3, 10) 242, (5, 5) 246; float64 (3, 5)
  // 214; (5, 10), and float64 beyond (3, 5), spill)
  BT_ONCHIP_CASE(3, 5)
  if constexpr (std::is_same_v<F, float>) {
    BT_ONCHIP_CASE(3, 10)
    BT_ONCHIP_CASE(5, 5)
  }
#undef BT_ONCHIP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int N, typename F>
void launch_stream(const void* D, const void* O, const void* b, void* x,
                   void* scratch, int B, int T, double reg,
                   cudaStream_t s) {
  using C = typename Compute<N, F>::type;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  btsolve_kernel<N, F><<<blocks, threads, 0, s>>>(
      static_cast<const F*>(D), static_cast<const F*>(O),
      static_cast<const F*>(b), static_cast<F*>(x), static_cast<C*>(scratch),
      B, T, static_cast<C>(static_cast<F>(reg)));
}

// Bytes of the streaming kernel's scratch at (N, F): L and S, and where C
// is wider than F the parked y.
template <int N, typename F>
long long stream_scratch_bytes(int B, int T) {
  using C = typename Compute<N, F>::type;
  const long long parked = std::is_same_v<C, F> ? 0 : T * N;
  return (2LL * T * N * N + parked) * B * static_cast<long long>(sizeof(C));
}

template <typename F>
int launch(const void* D, const void* O, const void* b, void* x,
           void* scratch, int B, int T, int n, double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3:
      launch_stream<3, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 4:
      launch_stream<4, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 5:
      launch_stream<5, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 6:
      launch_stream<6, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 7:
      launch_stream<7, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 16:
      launch_stream<16, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
long long scratch_bytes(int B, int T, int n) {
  switch (n) {
    case 3: return stream_scratch_bytes<3, F>(B, T);
    case 4: return stream_scratch_bytes<4, F>(B, T);
    case 5: return stream_scratch_bytes<5, F>(B, T);
    case 6: return stream_scratch_bytes<6, F>(B, T);
    case 7: return stream_scratch_bytes<7, F>(B, T);
    case 16: return stream_scratch_bytes<16, F>(B, T);
    default: return -1;
  }
}

}  // namespace dqmpc

// D [B,T,n,n], O [B,T-1,n,n], b [B,T,n] -> x [B,T,n], all contiguous.
// Streaming layout: scratch holds btsolve_scratch_bytes_<dtype>(B, T, n)
// bytes. Returns a cudaError_t code.
extern "C" int btsolve_f32(const void* D, const void* O, const void* b,
                           void* x, void* scratch, int B, int T, int n,
                           double reg, void* stream) {
  return dqmpc::launch<float>(D, O, b, x, scratch, B, T, n, reg, stream);
}

extern "C" int btsolve_f64(const void* D, const void* O, const void* b,
                           void* x, void* scratch, int B, int T, int n,
                           double reg, void* stream) {
  return dqmpc::launch<double>(D, O, b, x, scratch, B, T, n, reg, stream);
}

// Bytes of the streaming layout's scratch; -1 for an unbuilt n.
extern "C" long long btsolve_scratch_bytes_f32(int B, int T, int n) {
  return dqmpc::scratch_bytes<float>(B, T, n);
}

extern "C" long long btsolve_scratch_bytes_f64(int B, int T, int n) {
  return dqmpc::scratch_bytes<double>(B, T, n);
}

// On-chip layout, no scratch. cudaErrorInvalidValue for an (n, T) without
// an instantiation.
extern "C" int btsolve_onchip_f32(const void* D, const void* O,
                                  const void* b, void* x, int B, int T, int n,
                                  double reg, void* stream) {
  return dqmpc::launch_onchip_shape<float>(D, O, b, x, B, T, n, reg, stream);
}

extern "C" int btsolve_onchip_f64(const void* D, const void* O,
                                  const void* b, void* x, int B, int T, int n,
                                  double reg, void* stream) {
  return dqmpc::launch_onchip_shape<double>(D, O, b, x, B, T, n, reg, stream);
}
