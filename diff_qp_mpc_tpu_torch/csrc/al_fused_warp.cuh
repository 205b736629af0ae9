// K2 with one warp per batch element and the element's blocks in shared
// memory: the whole augmented-Lagrangian MPC solve of the quadrotor (n =
// NX + NU = 16) and of the cartpoles (n 5 and 7).
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/al_fused_pallas.py::
// fused_al_solve (_al_kernel) for a model whose element does not fit one
// lane: al_fused_common.cuh's kernel keeps the element in one lane's
// registers, about 4,600 values at nx 12, nu 4, T 5 against a lane's 255
// registers (the TPU kernel met the same wall in VMEM and built each stage's
// D/O blocks lazily inside the factor sweep, al_fused_pallas.py:157-199).
// Here each element's trajectory, cost, multipliers, Jacobians [A B], the
// factor L (packed lower, one 16×16 block a stage) and the Schur blocks S
// live in dynamic shared memory (WarpElement: 12.3 KB in float32, 24.7 KB in
// float64), kWarpsPerBlock elements a block, and the warp's lanes share the
// element's work:
//   - the Jacobian: (T − 1)·16 forward-mode columns of the RK4 step, one
//     column a lane (the step and one column are the called device
//     functions rk4_value / rk4_column of al_fused_common.cuh);
//   - the merit gradient, D_t (lanes take the 136 entries of each stage's
//     lower triangle, GᵀG by 12-term dots) and the Schur update;
//   - the block Cholesky column by column, lanes taking the rows below the
//     pivot (a __syncwarp between columns), S_t = O_{t-1} L_{t-1}⁻ᵀ and
//     the triangular vector solves with lanes taking rows;
//   - the line search: lanes take candidates k ≡ lane (mod 32), then
//     line_search_pick's (merit, k) butterfly, which reproduces the serial
//     first-minimum rule exactly.
// Semantics are al_fused_common.cuh's (its header lists them): x₀ pinned,
// the candidate cost as q0 + a·q1 + a²·q2, the strict-< first minimum over
// a = 2⁻ᵏ from float32's max, the incumbent kept bit-exact when no
// candidate beats it, λ_hi/λ_lo clamped at 0, ρ ← min(ρ·factor, rho_max),
// the same residual norm; the merit's dynamics term rounded before it is
// summed (kRoundedMerit). Sums over the warp (q0, q1, q2, the current
// merit's cost) and the upper triangular solves run in another order than
// the one-lane kernel's, so the two agree to rounding, not bit for bit.
//
// The cartpoles' elements fit a lane's registers only with spills of 0.9-12
// KB a thread (al_fused_common.cuh's group layout, which they ran on before,
// 2.3-7.2× slower at B 64-4096); here they take 1.8-6.6 KB of shared memory
// an element in float32.
//
// Bound on the H100: 2.5·10⁶ operations and 2 KB of device memory an element
// in float32 at the quadrotor checkpoint's budget (benchmarks/flops.py), so
// the operations. At the main path's B 64-128 a launch occupies one warp on each
// of a few dozen SMs, and each element is a chain of dependent phases a warp
// long, so it is latency-bound:
// the Jacobian's dual RK4 columns, the 20 candidates' four RK4 steps each,
// and the 16 sequential columns of each of the 5 block Choleskys.
#pragma once

#include "al_fused_common.cuh"

namespace dqmpc {

constexpr unsigned kFullWarp = 0xffffffffu;
// elements (warps) a block
constexpr int kWarpsPerBlock = 2;

template <int NX, int NU, int T, typename F>
struct WarpElement {
  static constexpr int N = NX + NU;
  static constexpr int NP = N * (N + 1) / 2;
  F Cd[T][N], cv[T][N], w[T][N], grad[T][N];
  // the forward solve's y, then the Newton direction d, in place
  F d[T][N];
  F x0[NX];
  F lamd[T - 1][NX], lamh[T][NU], laml[T][NU];
  F G[T - 1][NX][N];  // [A_t B_t], the step's Jacobian at stage t
  F f[T - 1][NX];     // the step at stage t
  F vd[T - 1][NX];    // λ_t + ρ (x_{t+1} − f_t)
  F mask[T][NU];      // active bounds
  F L[T][NP];         // D_t, then the factor of stage t, lower by rows
  F S[T - 1][N][N];   // S[t − 1] = S_t = O_{t-1} L_{t-1}⁻ᵀ, t ≥ 1
};

// index of (i, j), j ≤ i, in a lower triangle packed by rows
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// (i, j) of the packed index e
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  if (tri(i, 0) > e) --i;
  if (tri(i + 1, 0) <= e) ++i;
  j = e - tri(i, 0);
}

// the sum over the warp, the same bits on every lane
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = v + __shfl_xor_sync(kFullWarp, v, s);
  return v;
}

// stage t of w + a·d (or of w), x₀ pinned, as the step's argument
template <class Sys, int T, typename F>
__device__ __forceinline__ Vec<F, Sys::NX + Sys::NU> stage(
    const WarpElement<Sys::NX, Sys::NU, T, F>& s, int t, F a, bool along) {
  constexpr int NX = Sys::NX, N = Sys::NX + Sys::NU;
  Vec<F, N> xu;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const F v = along ? s.w[t][i] + a * s.d[t][i] : s.w[t][i];
    xu.v[i] = (t == 0 && i < NX) ? s.x0[i] : v;
  }
  return xu;
}

// The merit's dynamics and bound terms (merit_constraints of
// al_fused_common.cuh, kRoundedMerit) of w + a·d (along) or of w, one lane.
template <class Sys, int T, typename F>
__device__ F warp_merit_constraints(
    const typename Sys::template Params<F>& p,
    const WarpElement<Sys::NX, Sys::NU, T, F>& s, F a, bool along, F rho,
    const Box<F, Sys::NU>& box) {
  constexpr int NX = Sys::NX, NU = Sys::NU;
  F m = F(0);
#pragma unroll 1
  for (int t = 0; t < T - 1; ++t) {
    const Vec<F, NX> f = rk4_value<Sys, F>(p, stage<Sys, T, F>(s, t, a, along));
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const F wn = along ? s.w[t + 1][i] + a * s.d[t + 1][i] : s.w[t + 1][i];
      const F r = wn - f.v[i];
      m = m + mul_rn(s.lamd[t][i], r) + mul_rn(mul_rn(F(0.5) * rho, r), r);
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const F u = along ? s.w[t][NX + i] + a * s.d[t][NX + i] : s.w[t][NX + i];
      const F rh = u - box.hi[i];
      const F rl = box.lo[i] - u;
      const F ch = max_keep_nan(rh, F(0));
      const F cl = max_keep_nan(rl, F(0));
      m = m + s.lamh[t][i] * rh + s.laml[t][i] * rl +
          F(0.5) * rho * (ch * ch + cl * cl);
    }
  }
  return m;
}

// the step at every stage of w into s.f, lanes take stages
template <class Sys, int T, typename F>
__device__ __forceinline__ void warp_steps(
    const typename Sys::template Params<F>& p,
    WarpElement<Sys::NX, Sys::NU, T, F>& s, int lane) {
  for (int t = lane; t < T - 1; t += 32) {
    const Vec<F, Sys::NX> f =
        rk4_value<Sys, F>(p, stage<Sys, T, F>(s, t, F(0), false));
#pragma unroll
    for (int i = 0; i < Sys::NX; ++i) s.f[t][i] = f.v[i];
  }
  __syncwarp();
}

template <class Sys, int T, typename F>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
al_warp_kernel(typename Sys::template Params<F> p, const F* __restrict__ Cd_g,
               const F* __restrict__ c_g, const F* __restrict__ x0_g,
               const F* __restrict__ xi_g, const F* __restrict__ ui_g,
               const F* __restrict__ lamd_g, const F* __restrict__ lamh_g,
               const F* __restrict__ laml_g, const F* __restrict__ rho_g,
               F* __restrict__ w_out, F* __restrict__ lamd_out,
               F* __restrict__ lamh_out, F* __restrict__ laml_out,
               F* __restrict__ res_out, int B, int al_iter, int n_newton,
               int n_ls, F rho_factor, F rho_max, F reg,
               Box<F, Sys::NU> box) {
  constexpr int NX = Sys::NX, NU = Sys::NU, N = NX + NU;
  using E = WarpElement<NX, NU, T, F>;
  constexpr int NP = E::NP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= B) return;  // the whole warp: no shuffle waits on it
  E& s = reinterpret_cast<E*>(smem)[threadIdx.x >> 5];
  const size_t eT = static_cast<size_t>(e) * T;

  // ---- load, x₀ pinned ----
  for (int k = lane; k < T * N; k += 32) {
    const int t = k / N, i = k % N;
    s.Cd[t][i] = Cd_g[eT * N + k];
    s.cv[t][i] = c_g[eT * N + k];
    s.w[t][i] = i < NX ? xi_g[(eT + t) * NX + i] : ui_g[(eT + t) * NU + i - NX];
  }
  for (int k = lane; k < T * NU; k += 32) {
    s.lamh[k / NU][k % NU] = lamh_g[eT * NU + k];
    s.laml[k / NU][k % NU] = laml_g[eT * NU + k];
  }
  for (int k = lane; k < (T - 1) * NX; k += 32)
    s.lamd[k / NX][k % NX] = lamd_g[static_cast<size_t>(e) * (T - 1) * NX + k];
  if (lane < NX) s.x0[lane] = x0_g[static_cast<size_t>(e) * NX + lane];
  __syncwarp();
  if (lane < NX) s.w[0][lane] = s.x0[lane];
  F rho = rho_g[e];
  __syncwarp();

  for (int it = 0; it < al_iter; ++it) {
    F merit_cur = warp_merit_constraints<Sys, T, F>(p, s, F(0), false, rho,
                                                    box);
    {
      F cost = F(0);
      for (int k = lane; k < T * N; k += 32) {
        const int t = k / N, i = k % N;
        cost = cost + F(0.5) * s.Cd[t][i] * s.w[t][i] * s.w[t][i] +
               s.cv[t][i] * s.w[t][i];
      }
      merit_cur = merit_cur + warp_sum(cost);
    }

    for (int nt = 0; nt < n_newton; ++nt) {
      // ---- the step and its Jacobian at every stage, a column a lane ----
      for (int k = lane; k < (T - 1) * N; k += 32) {
        const int t = k / N, j = k % N;
        const Vec<F, NX> col =
            rk4_column<Sys, F>(p, stage<Sys, T, F>(s, t, F(0), false), j);
#pragma unroll
        for (int i = 0; i < NX; ++i) s.G[t][i][j] = col.v[i];
      }
      warp_steps<Sys, T, F>(p, s, lane);
      for (int k = lane; k < (T - 1) * NX; k += 32) {
        const int t = k / NX, i = k % NX;
        s.vd[t][i] = s.lamd[t][i] + rho * (s.w[t + 1][i] - s.f[t][i]);
      }
      __syncwarp();
      // ---- merit gradient: cost' + Jᵀ(λ + ρ r_clamped), x₀ pinned ----
      for (int k = lane; k < T * N; k += 32) {
        const int t = k / N, i = k % N;
        F g = s.Cd[t][i] * s.w[t][i] + s.cv[t][i];
        if (i < NX && t > 0) g = g + s.vd[t - 1][i];
        if (t < T - 1) {
#pragma unroll
          for (int q = 0; q < NX; ++q) g = g - s.G[t][q][i] * s.vd[t][q];
        }
        if (i >= NX) {
          const int c = i - NX;
          const F rh = s.w[t][i] - box.hi[c];
          const F rl = box.lo[c] - s.w[t][i];
          s.mask[t][c] = F(rh > F(0) ? 1 : 0) + F(rl > F(0) ? 1 : 0);
          g = g + s.lamh[t][c] + rho * max_keep_nan(rh, F(0)) - s.laml[t][c] -
              rho * max_keep_nan(rl, F(0));
        }
        s.grad[t][i] = (t == 0 && i < NX) ? F(0) : g;
      }
      __syncwarp();

      // ---- Newton direction: block Cholesky with D/O built per stage ----
      // D_t = diag(Cd_t) + ρ (GᵀG [t<T-1] + [I 0; 0 mask_t]), pinned x₀
      // rows/columns at t = 0; O_t = −ρ [A B; 0 0]
#pragma unroll 1
      for (int t = 0; t < T; ++t) {
        F* Lt = s.L[t];
        if (t > 0 && lane < N) {  // S_t Lᵀ_{t-1} = O_{t-1}, a row a lane
          const F* Lp = s.L[t - 1];
          F* Sr = s.S[t - 1][lane];
#pragma unroll
          for (int c = 0; c < N; ++c) {
            F acc = (lane < NX && !(t == 1 && c < NX))
                        ? -rho * s.G[t - 1][lane][c]
                        : F(0);
#pragma unroll
            for (int k = 0; k < c; ++k) acc = acc - Sr[k] * Lp[tri(c, k)];
            Sr[c] = acc / Lp[tri(c, c)];
          }
        }
        for (int k = lane; k < NP; k += 32) {
          int i, j;
          untri(k, i, j);
          F v = F(0);
          if (i == j)
            v = s.Cd[t][i] + (i < NX ? rho : rho * s.mask[t][i - NX]);
          if (t < T - 1) {
            F acc = F(0);
#pragma unroll
            for (int q = 0; q < NX; ++q)
              acc = acc + s.G[t][q][i] * s.G[t][q][j];
            v = v + rho * acc;
          }
          if (t == 0 && j < NX) v = i == j ? F(1) : F(0);
          Lt[k] = v;
        }
        __syncwarp();
        for (int k = lane; k < NP; k += 32) {  // D_t − S_t S_tᵀ + reg·I
          int i, j;
          untri(k, i, j);
          F acc = Lt[k];
          if (t > 0) {
#pragma unroll
            for (int q = 0; q < N; ++q)
              acc = acc - s.S[t - 1][i][q] * s.S[t - 1][j][q];
          }
          Lt[k] = i == j ? acc + reg : acc;
        }
        __syncwarp();
        // Cholesky in place, column by column, a row a lane; the pivot's
        // floor 1e-30 as chol's (bt_common.cuh)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          F sv = F(0);
          if (lane >= j && lane < N) {
            sv = Lt[tri(lane, j)];
#pragma unroll
            for (int k = 0; k < j; ++k)
              sv = sv - Lt[tri(lane, k)] * Lt[tri(j, k)];
          }
          const F piv =
              sqrt(max_keep_nan(__shfl_sync(kFullWarp, sv, j), F(1e-30)));
          if (lane > j && lane < N) Lt[tri(lane, j)] = sv / piv;
          if (lane == j) Lt[tri(j, j)] = piv;
          __syncwarp();
        }
      }
      // forward: y_t = L_t⁻¹ (grad_t − S_t y_{t-1}), a row a lane, into d
#pragma unroll 1
      for (int t = 0; t < T; ++t) {
        const F* Lt = s.L[t];
        F v = F(0);
        if (lane < N) {
          v = s.grad[t][lane];
          if (t > 0) {
#pragma unroll
            for (int k = 0; k < N; ++k)
              v = v - s.S[t - 1][lane][k] * s.d[t - 1][k];
          }
        }
        F y = F(0);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const F yi =
              __shfl_sync(kFullWarp, lane == i ? v / Lt[tri(i, i)] : F(0), i);
          if (lane == i) y = yi;
          if (lane > i && lane < N) v = v - Lt[tri(lane, i)] * yi;
        }
        if (lane < N) s.d[t][lane] = y;
        __syncwarp();
      }
      // backward: d_t = L_t⁻ᵀ (y_t − S_{t+1}ᵀ d_{t+1}), in place
#pragma unroll 1
      for (int t = T - 1; t >= 0; --t) {
        const F* Lt = s.L[t];
        F v = F(0);
        if (lane < N) {
          v = s.d[t][lane];
          if (t < T - 1) {
#pragma unroll
            for (int k = 0; k < N; ++k)
              v = v - s.S[t][k][lane] * s.d[t + 1][k];
          }
        }
        F x = F(0);
#pragma unroll
        for (int i = N - 1; i >= 0; --i) {
          const F xi =
              __shfl_sync(kFullWarp, lane == i ? v / Lt[tri(i, i)] : F(0), i);
          if (lane == i) x = xi;
          if (lane < i) v = v - Lt[tri(i, lane)] * xi;
        }
        if (lane < N) s.d[t][lane] = x;
        __syncwarp();
      }
      for (int k = lane; k < T * N; k += 32)
        s.d[k / N][k % N] = -s.d[k / N][k % N];
      __syncwarp();

      // ---- line search over a = 2⁻ᵏ, cost term as a polynomial in a ----
      F q0 = F(0), q1 = F(0), q2 = F(0);
      for (int k = lane; k < T * N; k += 32) {
        const int t = k / N, i = k % N;
        const F wv = s.w[t][i], dv = s.d[t][i], cd = s.Cd[t][i];
        q0 = q0 + F(0.5) * cd * wv * wv + s.cv[t][i] * wv;
        q1 = q1 + (cd * wv + s.cv[t][i]) * dv;
        q2 = q2 + F(0.5) * cd * dv * dv;
      }
      q0 = warp_sum(q0);
      q1 = warp_sum(q1);
      q2 = warp_sum(q2);
      F best_m = F(FLT_MAX);
      int best_k = n_ls;
      for (int k = lane; k < n_ls; k += 32) {
        const F a = F(ldexpf(1.0f, -k));  // float32 step, as the reference
        const F mk = q0 + a * q1 + (a * a) * q2 +
                     warp_merit_constraints<Sys, T, F>(p, s, a, true, rho, box);
        if (mk < best_m) {
          best_m = mk;
          best_k = k;
        }
      }
      line_search_pick<32, F>(kFullWarp, best_m, best_k);
      if (best_m < merit_cur) {  // the same on every lane
        const F a = best_k < n_ls ? F(ldexpf(1.0f, -best_k)) : F(0);
        for (int k = lane; k < T * N; k += 32) {
          const int t = k / N, i = k % N;
          if (!(t == 0 && i < NX)) s.w[t][i] = s.w[t][i] + a * s.d[t][i];
        }
        merit_cur = best_m;
      }
      __syncwarp();
    }

    // ---- AL outer update ----
    warp_steps<Sys, T, F>(p, s, lane);
    for (int k = lane; k < (T - 1) * NX; k += 32) {
      const int t = k / NX, i = k % NX;
      s.lamd[t][i] = s.lamd[t][i] + rho * (s.w[t + 1][i] - s.f[t][i]);
    }
    for (int k = lane; k < T * NU; k += 32) {
      const int t = k / NU, i = k % NU;
      const F rh = s.w[t][NX + i] - box.hi[i];
      const F rl = box.lo[i] - s.w[t][NX + i];
      s.lamh[t][i] = max_keep_nan(s.lamh[t][i] + rho * rh, F(0));
      s.laml[t][i] = max_keep_nan(s.laml[t][i] + rho * rl, F(0));
    }
    const F rho_next = rho * rho_factor;
    rho = rho_next < rho_max ? rho_next : rho_max;
    __syncwarp();
  }

  // ---- outputs ----
  warp_steps<Sys, T, F>(p, s, lane);
  if (lane == 0) {  // the residual norm in the one-lane kernel's order
    F res2 = F(0);
#pragma unroll
    for (int t = 0; t < T - 1; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const F r = s.w[t + 1][i] - s.f[t][i];
        res2 = res2 + r * r;
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const F ch = max_keep_nan(s.w[t][NX + i] - box.hi[i], F(0));
        const F cl = max_keep_nan(box.lo[i] - s.w[t][NX + i], F(0));
        res2 = res2 + ch * ch + cl * cl;
      }
    }
    res_out[e] = sqrt(res2);
  }
  for (int k = lane; k < T * N; k += 32) w_out[eT * N + k] = s.w[k / N][k % N];
  for (int k = lane; k < T * NU; k += 32) {
    lamh_out[eT * NU + k] = s.lamh[k / NU][k % NU];
    laml_out[eT * NU + k] = s.laml[k / NU][k % NU];
  }
  for (int k = lane; k < (T - 1) * NX; k += 32)
    lamd_out[static_cast<size_t>(e) * (T - 1) * NX + k] = s.lamd[k / NX][k % NX];
}

// Shared memory of the (Sys, T, F) instantiation: bytes an element and a
// block, and the most a block may ask of the current device.
template <class Sys, int T, typename F>
int warp_smem(int* per_element, int* per_block, int* device_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(device_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *per_element = static_cast<int>(sizeof(WarpElement<Sys::NX, Sys::NU, T, F>));
  *per_block = *per_element * kWarpsPerBlock;
  return static_cast<int>(err);
}

// One launch of the (Sys, T, F) instantiation, kWarpsPerBlock elements a
// block; params are Sys's host-folded double constants (Sys::load).
template <class Sys, int T, typename F>
int launch_warp(const Args& a, int B, int al_iter, int n_newton, int n_ls,
                double rho_factor, double rho_max, double reg,
                const double* params, const double* u_lo, const double* u_hi,
                cudaStream_t s) {
  Box<F, Sys::NU> box;
  for (int i = 0; i < Sys::NU; ++i) {
    box.lo[i] = static_cast<F>(u_lo[i]);
    box.hi[i] = static_cast<F>(u_hi[i]);
  }
  int per_element = 0, per_block = 0, device_max = 0;
  cudaError_t err = static_cast<cudaError_t>(
      warp_smem<Sys, T, F>(&per_element, &per_block, &device_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_block > device_max)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(al_warp_kernel<Sys, T, F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  al_warp_kernel<Sys, T, F><<<blocks, 32 * kWarpsPerBlock, per_block, s>>>(
      Sys::template load<F>(params), static_cast<const F*>(a.Cd),
      static_cast<const F*>(a.c), static_cast<const F*>(a.x0),
      static_cast<const F*>(a.xi), static_cast<const F*>(a.ui),
      static_cast<const F*>(a.lamd), static_cast<const F*>(a.lamh),
      static_cast<const F*>(a.laml), static_cast<const F*>(a.rho),
      static_cast<F*>(a.w), static_cast<F*>(a.lamd_o),
      static_cast<F*>(a.lamh_o), static_cast<F*>(a.laml_o),
      static_cast<F*>(a.res), B, al_iter, n_newton, n_ls,
      static_cast<F>(rho_factor), static_cast<F>(rho_max),
      static_cast<F>(reg), box);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dqmpc

// The AL solve of one model on the warp layout, with AL_FUSED_ENTRY's
// arguments; log2G must be 5 (the element's group is the whole warp).
// Returns a cudaError_t code: cudaErrorInvalidValue for an unbuilt T or
// another log2G, cudaErrorInvalidConfiguration when a block's shared memory
// exceeds what the device allows. The cases name the built horizons:
// AL_WARP_CASE(T, Sys, F).
#define AL_WARP_ENTRY(NAME, F, ...)                                           \
  extern "C" int NAME(                                                        \
      const void* Cd, const void* c, const void* x0, const void* xi,          \
      const void* ui, const void* lamd, const void* lamh, const void* laml,   \
      const void* rho, void* w, void* lamd_o, void* lamh_o, void* laml_o,     \
      void* res, int B, int log2G, int T, int al_iter, int n_newton,          \
      int n_ls, double rho_factor, double rho_max, double reg,                \
      const double* params, const double* u_lo, const double* u_hi,           \
      void* stream) {                                                         \
    dqmpc::Args a{Cd, c, x0, xi, ui, lamd, lamh, laml, rho,                   \
                  w, lamd_o, lamh_o, laml_o, res};                            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    if (log2G != 5) return static_cast<int>(cudaErrorInvalidValue);           \
    switch (T) { __VA_ARGS__ }                                                \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }

#define AL_WARP_CASE(TT, Sys, F)                                              \
  case TT:                                                                    \
    return dqmpc::launch_warp<Sys, TT, F>(a, B, al_iter, n_newton, n_ls,      \
                                          rho_factor, rho_max, reg, params,   \
                                          u_lo, u_hi, s);

// Shared memory of the (T, dtype) instantiation (see dqmpc::warp_smem).
#define AL_WARP_SMEM_ENTRY(NAME, ...)                                         \
  extern "C" int NAME(int T, int* per_element, int* per_block,                \
                      int* device_max) {                                      \
    switch (T) { __VA_ARGS__ }                                                \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }
#define AL_WARP_SMEM_CASE(TT, Sys, F) \
  case TT:                            \
    return dqmpc::warp_smem<Sys, TT, F>(per_element, per_block, device_max);
