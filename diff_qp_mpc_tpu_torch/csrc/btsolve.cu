// K1: batched block-tridiagonal Cholesky factor + solve, H x = b.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/btsolve_pallas.py::
// batched_factor_solve (_factor_solve_kernel). Same function:
//   L₀L₀ᵀ = D₀ + reg·I;  Sₜ = Oₜ₋₁Lₜ₋₁⁻ᵀ;  LₜLₜᵀ = Dₜ − SₜSₜᵀ + reg·I,
// then block forward (L y = b) and backward (Lᵀ x = y) substitution.
//
// Design: one thread per batch element; n is a template parameter (3, 5, 7,
// 16: the models' nx+nu), T a run-time value. The forward substitution runs
// inside the factor sweep, so only the factor's Lₜ and Sₜ go to a scratch
// tensor (needed again by the backward sweep). Scratch is batch-minor,
// [2][T][n][n][B], so neighbouring threads touch neighbouring addresses; y
// is parked in the output x and overwritten by the backward sweep.
//
// Bound on the H100: at the main path's shapes (B = 64 .. 4096, T = 5,
// n = 3) the work is ~500 flops and ~450 bytes per element, so the card's
// bound is the bytes; but B is far below the 132 SMs × 2048 threads the
// card holds, so a launch is latency-bound (one serial O(T n³) chain per
// thread). Making it fast (a warp per element, batch-minor inputs) is later
// work; this version is the simple, right one.
#include <cstddef>

#include "bt_common.cuh"

namespace dqmpc {

template <int N, typename F>
__global__ void __launch_bounds__(128)
btsolve_kernel(const F* __restrict__ D, const F* __restrict__ O,
               const F* __restrict__ b, F* __restrict__ x,
               F* __restrict__ scratch, int B, int T, F reg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  constexpr int NN = N * N;
  const F* De = D + static_cast<size_t>(e) * T * NN;
  const F* Oe = O + static_cast<size_t>(e) * (T - 1) * NN;
  const F* be = b + static_cast<size_t>(e) * T * N;
  F* xe = x + static_cast<size_t>(e) * T * N;
  // scratch entry (which, t, i, j) of element e; which 0 = L, 1 = S
  auto at = [&](int which, int t, int i, int j) -> F& {
    return scratch[(((static_cast<size_t>(which) * T + t) * N + i) * N + j) *
                       B + e];
  };

  F M[N][N], L[N][N], Lp[N][N], S[N][N], v[N], y[N], yp[N];

  // ---- stage 0: factor, forward solve ----
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) M[i][j] = De[i * N + j];
    M[i][i] = M[i][i] + reg;
  }
  chol<N, F>(M, L);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = be[i];
  solve_lower_vec<N, F>(L, v, y);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      at(0, 0, i, j) = L[i][j];
      Lp[i][j] = L[i][j];
    }
    xe[i] = y[i];
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
    solve_lower_mat<N, F>(Lp, M, S);
    const F* Dt = De + static_cast<size_t>(t) * NN;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = Dt[i * N + j];
    }
    schur_update<N, F>(M, S, reg);
    chol<N, F>(M, L);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      F s = be[t * N + i];
#pragma unroll
      for (int k = 0; k < N; ++k) s = s - S[i][k] * yp[k];
      v[i] = s;
    }
    solve_lower_vec<N, F>(L, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) at(1, t, i, j) = S[i][j];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        at(0, t, i, j) = L[i][j];
        Lp[i][j] = L[i][j];
      }
      xe[t * N + i] = y[i];
      yp[i] = y[i];
    }
  }

  // ---- backward: Lᵀ x = y; Lp, yp hold stage T-1 ----
  F xn[N];
  solve_upper_vec<N, F>(Lp, yp, xn);
#pragma unroll
  for (int i = 0; i < N; ++i) xe[(T - 1) * N + i] = xn[i];
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
      F s = xe[t * N + i];
#pragma unroll
      for (int k = 0; k < N; ++k) s = s - S[k][i] * xn[k];
      v[i] = s;
    }
    solve_upper_vec<N, F>(L, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xe[t * N + i] = y[i];
      xn[i] = y[i];
    }
  }
}

template <typename F>
int launch(const void* D, const void* O, const void* b, void* x,
           void* scratch, int B, int T, int n, double reg, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F* Dp = static_cast<const F*>(D);
  const F* Op = static_cast<const F*>(O);
  const F* bp = static_cast<const F*>(b);
  F* xp = static_cast<F*>(x);
  F* sp = static_cast<F*>(scratch);
  const F r = static_cast<F>(reg);
  switch (n) {
    case 3:
      btsolve_kernel<3, F><<<blocks, threads, 0, s>>>(Dp, Op, bp, xp, sp, B, T, r);
      break;
    case 5:
      btsolve_kernel<5, F><<<blocks, threads, 0, s>>>(Dp, Op, bp, xp, sp, B, T, r);
      break;
    case 7:
      btsolve_kernel<7, F><<<blocks, threads, 0, s>>>(Dp, Op, bp, xp, sp, B, T, r);
      break;
    case 16:
      btsolve_kernel<16, F><<<blocks, threads, 0, s>>>(Dp, Op, bp, xp, sp, B, T, r);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dqmpc

// D [B,T,n,n], O [B,T-1,n,n], b [B,T,n] -> x [B,T,n], all contiguous;
// scratch holds 2·T·n·n·B values. Returns a cudaError_t code.
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
