// Per-thread block helpers for the block-tridiagonal Cholesky, shared by
// btsolve.cu (K1) and al_fused.cu (K2); the Riccati solve of riccati.cu (K3)
// and trajqp_fused.cu (K4) factors its Quu blocks with them too.
//
// Each helper works on one batch element's N×N blocks held in registers
// (N a template parameter, every loop fully unrolled). The arithmetic and
// its order follow diff_qp_mpc_tpu/ops/btsolve_pallas.py (tile_chol,
// tile_solve_lower_mat, tile_solve_lower_vec, tile_solve_upper_vec), so the
// kernels and the reference round alike up to FMA contraction.
#pragma once

#include <cuda_runtime.h>

namespace dqmpc {

// max(v, floor) that keeps a NaN, as jnp.maximum and torch.clamp do.
template <typename F>
__device__ __forceinline__ F max_keep_nan(F v, F floor) {
  return (v != v || v > floor) ? v : floor;
}

// Lower Cholesky factor L of M, reading only M's lower triangle. The
// diagonal is sqrt(max(s, 1e-30)) so a breakdown gives a huge, finite
// direction that the line search rejects, never a trap.
template <int N, typename F>
__device__ __forceinline__ void chol(const F (&M)[N][N], F (&L)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      F s = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrt(max_keep_nan(s, F(1e-30)));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  }
}

// S Lᵀ = Bm for S (S = Bm L⁻ᵀ).
template <int N, typename F>
__device__ __forceinline__ void solve_lower_mat(const F (&L)[N][N],
                                                const F (&Bm)[N][N],
                                                F (&S)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F s = Bm[r][c];
#pragma unroll
      for (int k = 0; k < c; ++k) s = s - S[r][k] * L[c][k];
      S[r][c] = s / L[c][c];
    }
  }
}

// L y = v.
template <int N, typename F>
__device__ __forceinline__ void solve_lower_vec(const F (&L)[N][N],
                                                const F (&v)[N], F (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    F s = v[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
}

// Lᵀ x = v.
template <int N, typename F>
__device__ __forceinline__ void solve_upper_vec(const F (&L)[N][N],
                                                const F (&v)[N], F (&x)[N]) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    F s = v[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// M[i][j] -= Σₖ S[i][k] S[j][k] on the lower triangle, then + reg on the
// diagonal: the Schur complement Dₜ − SₜSₜᵀ + reg·I of one stage.
template <int N, typename F>
__device__ __forceinline__ void schur_update(F (&M)[N][N], const F (&S)[N][N],
                                             F reg) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      F acc = M[i][j];
#pragma unroll
      for (int k = 0; k < N; ++k) acc = acc - S[i][k] * S[j][k];
      M[i][j] = acc;
    }
    M[i][i] = M[i][i] + reg;
  }
}

}  // namespace dqmpc

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
